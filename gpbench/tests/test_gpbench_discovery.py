"""Configurations, traffic mixes and their kinds, data generators and
metric readers are found from their files by the names BENCHMARK.json and
the configurations give them."""
import json

import numpy as np
import pytest
import torch

import gpbench_tiny  # noqa: F401
from gpbench.lib import cell, spec, system, traffic

BENCH = spec.benchmark()


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(w):
    c = spec.cell(BENCH, w)
    assert c["config"]["name"] == c["workload"]["config"]
    kind = cell.kind(c["traffic"]["kind"])
    assert callable(kind.run) and callable(kind.readings)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"] and set(c["readers"]) == {
        m["name"] for m in c["per_layer"]}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_files_match_their_entries(m):
    reader = spec.metric_reader(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
        m["layer"], m["unit"], m["moves"])
    assert reader.read({"wall": 1.0}) is None  # nothing to read: no number


def test_config_entries_point_at_their_files():
    for c in BENCH["configs"]:
        with open(spec.ROOT.parent / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_new_config_is_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "extra.json").write_text('{"name": "extra"}')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "x", "config": "extra",
                               "traffic": "fit-10steps", "chips": 1})
    c = spec.cell(bench, "x", config_root=tmp_path)
    assert c["config"]["name"] == "extra"
    assert c["traffic"]["steps"] == 10


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_every_seed_asks_for_the_same_sizes(seed):
    mix = spec.traffic("posterior-1to64")
    sizes = traffic.request_sizes(mix)
    order = traffic.balanced_order(sizes, np.random.default_rng(seed))
    assert sorted(order) == sorted(sizes) and len(sizes) == 64
    # by rank: every stretch of 16 from the start takes one of each four
    ranks = traffic.balanced_order(list(range(64)),
                                   np.random.default_rng(seed))
    for k in range(0, 64, 16):
        assert {r // 4 for r in ranks[k:k + 16]} == set(range(16))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_finds_its_data_generator(c):
    cfg = spec.config(c["name"])
    cfg = {**cfg, "n": 16}
    x, y = system.make_data(cfg, 2**31 + 1, "cpu")
    assert x.shape == (16, cfg["d"]) and y.shape == (16,)
    assert torch.equal(y, system.make_data(cfg, 2**31 + 1, "cpu")[1])


def test_unknown_kind_and_generator_name_the_file_to_add():
    with pytest.raises(ValueError, match="traffic/kinds/burst.py"):
        cell.kind("burst")
    with pytest.raises(ValueError, match="gpbench/data/nosuch.py"):
        system.make_data({"data": {"generator": "nosuch"}}, 1, "cpu")
