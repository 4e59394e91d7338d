"""The frozen counts: launches and FLOPs of cfg1, the probabilistic net and
the train step; the same operations whatever dtype a call runs in; the
calls the program makes at a small size, shape for shape."""

import json
import os

import pytest
import torch

from bench_port import run
from bench_port.counts import m1

CFG1 = json.load(open(os.path.join(run.HERE, "configs", "cfg1.json")))["model"]
PROB = json.load(open(os.path.join(run.HERE, "configs", "prob.json")))["model"]


def test_cfg1_flops_a_volume():
    """93.2 GFLOP a cfg1 volume counted as chip_smoke.py counts it (a
    transposed conv's dilated input whole); 60.5 by what the convolutions
    need, the difference all in the four transposed convs."""
    dilated = m1.model_flops(m1.detect_calls(CFG1, 1, "float32", dilated=True))
    need = m1.model_flops(m1.detect_calls(CFG1, 1, "float32"))
    assert round(dilated / 1e9, 1) == 93.2
    assert round(need / 1e9, 2) == 60.50
    k2 = [c for c in m1.detect_calls(CFG1, 1, "float32", dilated=True) if c.kind == "K2"]
    k2n = [c for c in m1.detect_calls(CFG1, 1, "float32") if c.kind == "K2"]
    assert abs(sum(c.flops for c in k2) - sum(c.flops for c in k2n) - (dilated - need)) < 1


@pytest.mark.parametrize("cfg,train,expect", [
    (CFG1, False, {"K1": 50, "K2": 4, "K3": 37, "K4": 37}),
    (PROB, False, {"K1": 70, "K2": 8, "K3": 53, "K4": 53}),
    (CFG1, True, {"K1": 54, "K2": 53, "K3": 37, "K4": 37, "K6": 62, "K7": 37}),
], ids=["cfg1", "prob", "cfg1_train"])
def test_launches(cfg, train, expect):
    calls = (m1.train_calls if train else m1.detect_calls)(cfg, 2, "float32")
    assert m1.launches(calls) == expect


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_operations_do_not_depend_on_the_dtype(train):
    """fp32 K1/K2/K6 count the convolution's operations once, as bf16's do:
    no three TF32 products, no split-K partials."""
    fn = m1.train_calls if train else m1.detect_calls
    f32, b16 = fn(CFG1, 2, "float32"), fn(CFG1, 2, "bfloat16")
    assert [c.flops for c in f32] == [c.flops for c in b16]
    assert [c.kind for c in f32] == [c.kind for c in b16]
    assert all(a.bytes >= b.bytes for a, b in zip(f32, b16))


def _recorded_calls(cfg, batch, train):
    """The K1/K2 calls the program makes on the CPU at ``cfg``, as (kind,
    input voxels x channels, kernel taps x Cin x Cout)."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    seen = []
    plain1, plain2 = cv.conv3d_plain, cv.conv3d_transpose_plain

    def k1(parts, kernel, bias=None, strides=(1, 1, 1)):
        seen.append(("K1", sum(p.numel() for p in parts), kernel.numel()))
        return plain1(parts, kernel, bias, strides)

    def k2(x, kernel, bias=None, strides=(1, 1, 1)):
        seen.append(("K2", x.numel(), kernel.numel()))
        return plain2(x, kernel, bias, strides)

    cv.conv3d_plain, cv.conv3d_transpose_plain = k1, k2
    try:
        model = M1(**cfg, device="cpu", summary=False)
        x = torch.randn(batch, *cfg["input_spatial_dims"], cfg["input_channels"])
        g = torch.Generator().manual_seed(0)
        if train:
            out = model.net(x, train=True, rng=g)
            out["y_softmax"].sum().backward()
        else:
            with torch.no_grad():
                model.net.detect(x, rng=g)
    finally:
        cv.conv3d_plain, cv.conv3d_transpose_plain = plain1, plain2
    return seen


@pytest.mark.parametrize("which", ["cfg1", "prob"])
def test_counted_calls_are_the_programs(which):
    """At a small size the program's forward makes the counted K1/K2 calls:
    the same number of each, and the same multiply-adds in all."""
    from bench_port.tests.conftest import TINY

    cfg = dict(CFG1 if which == "cfg1" else PROB, **TINY)
    seen = _recorded_calls(cfg, 2, False)
    counted = m1.detect_calls(cfg, 2, "float32")
    for kind in ("K1", "K2"):
        assert sum(1 for s in seen if s[0] == kind) == m1.launches(counted)[kind]


def test_train_forward_calls_are_counted():
    from bench_port.tests.conftest import TINY

    cfg = dict(CFG1, **TINY)
    seen = _recorded_calls(cfg, 2, True)
    counts = m1.launches(m1.train_calls(cfg, 2, "float32"))
    assert sum(1 for s in seen if s[0] == "K1") == counts["K1"]
    assert sum(1 for s in seen if s[0] == "K2") == counts["K2"]
