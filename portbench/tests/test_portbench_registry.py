"""Everything a cell of BENCHMARK.json names is found by name: its
configuration file and recipe, its traffic mix, its limits, and each
per-layer metric's reader (and a roofline's counting module)."""

import importlib
import json
import os
import re

import pytest

from pb import check, configs, traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    cfg = configs.load(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert importlib.import_module(f"recipes.{cfg['recipe']}").build
    mix = traffic.load(w["traffic"])
    assert traffic.CameraPath(mix, cfg).pose(0)
    assert set(check.load_limits(cell)) == set(check.NUMBERS)
    assert w["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_found_by_name(metric):
    mod = importlib.import_module(f"metrics.{metric}")
    assert callable(mod.read)
    for module, attr in mod.WRAPS:
        assert callable(getattr(importlib.import_module(module), attr))
    k = getattr(mod, "KERNEL", None)
    if k is not None:
        for module, attr in k.COUNTERS:
            assert isinstance(getattr(importlib.import_module(module), attr),
                              int)
        for (module, attr), red in k.CALLS.items():
            assert callable(getattr(importlib.import_module(module), attr))
            assert callable(getattr(k, red))


def test_names_units_and_keys_keep_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] == "frame_ms"
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        cfg = configs.load(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
    assert {w["config"] for w in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}


def test_a_later_mix_is_a_data_file():
    """A new traffic mix needs no code: the generator reads any file of
    the known camera kinds."""
    cfg = configs.load("northstar")
    loop = traffic.CameraPath({"camera": {"kind": "loop", "center_ahead": 5.0,
                                          "radius": 3.0, "height": 1.0,
                                          "pitch": 0.0, "period_frames": 8},
                               "dt": 0.1}, cfg)
    assert loop.pose(3) == loop.pose(11)
