"""The comparison that decides ``correct``, driven through a whole run at a
small size on the CPU (the program's plain twins): the sound program reads
near nothing in fp32 with the draws made from the same seeds; each fault a
cell can have, planted under the timed path, comes out not correct; the
serve cells' control (the program's own fp8 activation store) reads well
above the sound bf16 program."""

import pytest

from bench_port import run
from bench_port.tests.conftest import TINY

SEED = 2 ** 31 + 12345  # a seed past 32 signed bits
GLAND = {"case_shape": [6, 24, 24], "cases": 3, "group_size": 3}
TRAIN = {"batch": 4, "cases": 12}
TRAIN_MODEL = dict(TINY, input_spatial_dims=[4, 32, 32])


def _run(cell, variant=None, workload=None, model=None, seconds=1.0):
    return run.run_cell(cell, SEED, seconds, False, device="cpu", variant=variant,
                        overrides={"model": model or TINY, "workload": workload or {}})


def _checks(r):
    out = {c["name"]: c["value"] for c in r["checks"]}
    out.update({c["name"] + ".widest": c["widest"] for c in r["checks"] if "widest" in c})
    return out


@pytest.mark.parametrize("cell", ["cfg1_mc4_b2", "prob_mc4_b2"])
def test_serve_reference_agrees_in_fp32(cell):
    r = _run(cell, workload={"dtype": "float32"})
    got = _checks(r)
    assert max(got.values()) < 1e-5, got
    assert r["correct"] and r["attempted"] >= 1


def test_gland_reference_agrees_in_fp32():
    got = _checks(_run("cfg1_gland_fp32", workload=GLAND))
    assert got["mean_max_gap"] < 1e-5 and got["std_max_gap"] < 1e-5, got


def test_train_reference_agrees_in_fp32():
    r = _run("cfg1_train_b16", workload=TRAIN, model=TRAIN_MODEL)
    got = _checks(r)
    assert got["loss1_gap"] < 1e-6 and got["grad_median_gap"] < 1e-5, got
    assert got["change_median_gap"] < 1e-5, got
    assert r["correct"]


@pytest.mark.parametrize("cell,variant", [
    ("cfg1_mc4_b2", "alter_answer"), ("cfg1_mc4_b2", "half_batch"),
    ("cfg1_mc4_b2", "nan_answer"),
    ("prob_mc4_b2", "alter_answer"), ("prob_mc4_b2", "half_batch"),
    ("cfg1_gland_fp32", "alter_answer"), ("cfg1_gland_fp32", "nan_answer"),
    ("cfg1_train_b16", "frozen_state"), ("cfg1_train_b16", "half_batch"),
])
def test_a_fault_under_the_timed_path_is_not_correct(cell, variant):
    kw = {"cfg1_gland_fp32": dict(workload=GLAND),
          "cfg1_train_b16": dict(workload=TRAIN, model=TRAIN_MODEL)}.get(cell, {})
    r = _run(cell, variant, **kw)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["cfg1_mc4_b8", "prob_mc4_b8", "cfg1_mc4_b2", "prob_mc4_b2"])
def test_the_control_is_not_correct(cell):
    """The program with its fp8 activation store (the precision below the
    cell's bf16) comes out not correct where the program is, at the
    configuration's widths on a 4x32x32 window."""
    model = {"input_spatial_dims": [4, 32, 32]}
    sound = _run(cell, model=model, workload={"check_requests": 1}, seconds=0.5)
    control = _run(cell, "control", model=model, workload={"check_requests": 1}, seconds=0.5)
    assert sound["correct"] is True, sound["checks"]
    assert control["correct"] is False, control["checks"]
    assert _checks(control)["mean_abs_gap"] > 3 * _checks(sound)["mean_abs_gap"]


def test_a_gap_that_is_not_a_number_is_as_wide_as_can_be():
    import json
    import math

    import torch

    from bench_port.reference import compare

    got = torch.zeros(4)
    got[2] = float("nan")
    assert compare.max_abs(got, torch.zeros(4)) == math.inf
    assert compare.mean_abs(got, torch.zeros(4)) == math.inf
    assert max(0.0, compare.max_abs(got, torch.zeros(4))) == math.inf
    c = compare.check("gap", float("nan"), 1e-3)
    assert c["value"] == math.inf
    assert json.loads(json.dumps(run.strict({"checks": [c]}), allow_nan=False)) == {
        "checks": [{"name": "gap", "value": "inf", "limit": 1e-3}]}
