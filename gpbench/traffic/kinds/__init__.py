"""Kinds of traffic, one file each, found by a mix's ``"kind"``
(``<kind>.py`` here). A kind gives ``run(cell, seed, seconds, traced,
device, t_start)``, one run of a cell of that kind, and ``readings(cell,
seed, device, control, faults)``, the readings ``gpbench/calibrate.py``
sets the correctness limits from. Its mixes are data files
(``gpbench/traffic/<mix>.json``)."""
