"""Data generators, one file each, found by the ``data.generator`` name of
a configuration (``<generator>.py`` here): ``make(cfg, g, device)``
returns (x [n, d], y [n]) in float32 on ``device``, drawn from the
generator ``g``."""
