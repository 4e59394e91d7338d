"""BENCHMARK.json against the contract's shape, and every file it names."""

import json
import os
import re

import pytest

from bench_port import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    """Each cell's workload file names an existing config and driver; each of
    its per-layer metrics has a reader; the end-to-end metric each moves is
    one the cell reports."""
    entry, wl, cfg, e2e, layer = run.cell_spec(cell, BENCH)
    assert wl["config"] == entry["config"] == cfg["name"]
    assert os.path.isfile(os.path.join(run.HERE, "drivers", f"{wl['driver']}.py"))
    e2e_names = {m["name"] for m in e2e}
    assert "setup_s" in e2e_names and len(e2e_names) >= 2
    assert layer
    for m in layer:
        assert os.path.isfile(os.path.join(run.HERE, "metrics", f"{m['name']}.py")), m
        assert m["moves"] in e2e_names, m


WORKLOADS = sorted(f[:-5] for f in os.listdir(os.path.join(run.HERE, "workloads")))


@pytest.mark.parametrize("cell", WORKLOADS)
def test_every_workload_file_names_its_pieces(cell):
    """Every workload file, in BENCHMARK.json or kept for later (PERF.md),
    names an existing config and driver, limits for its check, and a
    reader for each per-layer metric of its kind."""
    _, wl, cfg, _, _ = run.cell_spec(cell, BENCH)
    driver = os.path.join(run.HERE, "drivers", f"{wl['driver']}.py")
    assert os.path.isfile(driver) and cfg["name"] == wl["config"]
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    kind = {"serve": "serve", "train": "train", "gland": "gland"}[wl["driver"]]
    readers = [f for f in os.listdir(os.path.join(run.HERE, "metrics")) if f.endswith(f".{kind}.py")]
    assert len(readers) >= 3


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    """A config's file holds the model the cells run, its source and its cuts."""
    cfg = json.load(open(os.path.join(run.ROOT, config["file"])))
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"] == []
    assert config["file"].startswith("bench_port/configs/")


def test_layers_are_named_alike():
    """Metrics of one layer give it one name."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"device", "serving", "training", "kernels", "model"}


def test_configs_are_used_and_cells_run_one_chip():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
