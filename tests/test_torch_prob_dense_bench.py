"""The benchmark's reference, counts and cell for M1 with nested dense skips
(``bench_port/reference/m1_dense.py``, ``bench_port/counts/m1_dense.py``,
``bench_port/drivers/serve_dense.py``, cell ``prob_dense_mc4_b8``) on the
CPU: the plain reference against the port's M1 on the benchmark's seeded
weights and shared draws; the stitches' channel order pinned by swapping
two parts; the counted K1/K2 calls against the operations of the program's
conv modules at the published widths (meta tensors); one whole run of the
cell in fp32, and the faults planted under its timed path.

Tiny sizes are the benchmark tests' (``bench_port/tests/conftest.TINY``:
filters 4-24 on a 4x16x16 window).
"""

import json
import math
import os

import pytest
import torch

from bench_port import run
from bench_port.counts import m1 as counts_m1
from bench_port.counts import m1_dense as counts_dense
from bench_port.harness import seeds, weights
from bench_port.harness.session import build_model
from bench_port.reference import draws
from bench_port.reference import m1 as ref_m1
from bench_port.reference import m1_dense
from bench_port.reference.m1 import Net, to_ncdhw, to_ndhwc
from bench_port.tests.conftest import TINY
from prostatemr_3d_cad_cspca_tpu_torch.models import M1
from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import Conv3d, ConvTranspose3d
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

SEED = 2 ** 31 + 2022  # past 32 signed bits


def _config(name):
    with open(os.path.join(run.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


PROB_DENSE = _config("prob_dense")
# the deterministic trunk with dense skips (the reference's cfg2 wiring) at
# prob_dense's widths, MC dropout on: the reference's non-ladder dense path
DENSE = dict(PROB_DENSE["model"], input_channels=3, probabilistic=False)
MODELS = {"prob_dense": PROB_DENSE["model"], "dense": DENSE}


def _tiny(name):
    return dict(MODELS[name], **TINY)


def _weights(cfg):
    return weights.make(m1_dense.param_shapes(cfg), PROB_DENSE["weights"],
                        seeds.child(SEED, "weights"), "cpu")


def _input(cfg, batch=2):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(batch, *cfg["input_spatial_dims"], cfg["input_channels"], generator=gen)
    if cfg.get("probabilistic"):
        x[..., -(cfg["num_classes"] - 1):] = 0.0  # the label channel at test time
    return x


def _program_detect(cfg, params, x, seed):
    model = build_model(cfg, params, "float32", torch.device("cpu"))
    with torch.no_grad():
        return model.get_detect_model()(None, x, rng=torch.Generator().manual_seed(seed))


def _reference_detect(cfg, params, x, seed):
    with torch.no_grad():
        return to_ndhwc(m1_dense.detect(params, cfg, to_ncdhw(x), draws.Stream(seed, "cpu")))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_shapes_are_the_programs(name):
    """The reference names every parameter the program's M1 holds, at its
    shape (the program loads the benchmark's weights strictly)."""
    cfg = _tiny(name)
    model = M1(**cfg, device="cpu", init_params=False, summary=False)
    program = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    assert dict(m1_dense.param_shapes(cfg)) == program


@pytest.mark.parametrize("name", ["cfg1", "prob"])
def test_without_dense_skips_it_is_the_m1_reference(name):
    cfg = dict(_config(name)["model"], **TINY)
    assert m1_dense.param_shapes(cfg) == ref_m1.param_shapes(cfg)
    assert counts_dense.detect_calls(cfg, 8, "bfloat16") == counts_m1.detect_calls(cfg, 8,
                                                                                    "bfloat16")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_detect_agrees_with_the_program(name):
    """The inference head on seeded weights and one stream of draws (the MC
    dropouts, the ladder's latents): fp32 within 1e-5."""
    cfg = _tiny(name)
    params, x = _weights(cfg), _input(cfg)
    got = _program_detect(cfg, params, x, 11)
    want = _reference_detect(cfg, params, x, 11)
    assert got.shape == want.shape == (*x.shape[:4], cfg["num_classes"])
    assert float((got - want).abs().max()) < 1e-5


def test_mc_mean_std_agree_with_the_session():
    """``InferenceSession``'s MC-4 mean and std of a request against the
    reference's over the same draws (``fold_in(seed, call)``)."""
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    cfg = _tiny("prob_dense")
    params, x = _weights(cfg), _input(cfg, batch=2)
    model = build_model(cfg, params, "float32", torch.device("cpu"))
    session = InferenceSession(model, mc_iter=4, seed=SEED, device="cpu")
    mean, std = session(x.numpy())
    with torch.no_grad():
        mean_r, std_r = m1_dense.mc_mean_std(params, cfg, to_ncdhw(x),
                                             draws.Stream(draws.fold_in(SEED, 0), "cpu"), 4)
    assert float((torch.from_numpy(mean) - to_ndhwc(mean_r)).abs().max()) < 1e-5
    assert float((torch.from_numpy(std) - to_ndhwc(std_r)).abs().max()) < 1e-5
    assert float(std_r.mean()) > 1e-3  # the draws differ between samples


@pytest.mark.parametrize("name,block", [
    ("prob_dense", "sersd2"), ("prob_dense", "sersd1"), ("prob_dense", "sersp_1"),
    ("prob_dense", "sersp_2"), ("prob_dense", "sersp_3"),
    ("dense", "sersd2"), ("dense", "sersd1"), ("dense", "sersd0"),
])
def test_swapping_two_stitch_parts_breaks_agreement(monkeypatch, name, block):
    """The stitches' channel order is the program's: in the reference,
    swapping the two parts of one dense stitch before its gated skip (two
    parts of equal width) moves the output far past the agreement. (The
    ladder reads the trunk's stage-0 stitch, not its SE block, so sersd0 is
    pinned on the deterministic net.)"""
    cfg = _tiny(name)
    params, x = _weights(cfg), _input(cfg)
    got = _program_detect(cfg, params, x, 5)
    real, swapped = Net.se, []

    def swap(self, name, parts, stride):
        if name == block:
            parts = list(parts)
            parts[-3], parts[-2] = parts[-2], parts[-3]
            swapped.append(len(parts))
        return real(self, name, parts, stride)

    monkeypatch.setattr(Net, "se", swap)
    want = _reference_detect(cfg, params, x, 5)
    assert swapped and swapped[0] >= 3
    assert float((got - want).abs().max()) > 1e-3


def _program_calls(cfg, batch):
    """(kind, operations) of every K1/K2 call of the program's detect head
    at ``cfg``: the conv modules hooked on meta tensors (a SAME conv's
    output voxels, a transposed conv's input voxels, x taps x Cin x Cout)."""
    seen = []

    def k1(mod, args, out):
        k = mod.kernel.shape
        seen.append(("K1", 2.0 * out.shape[0] * math.prod(out.shape[1:4]) * math.prod(k)))

    def k2(mod, args, out):
        k, x = mod.kernel.shape, args[0]
        seen.append(("K2", 2.0 * x.shape[0] * math.prod(x.shape[1:4]) * math.prod(k)))

    model = M1(**cfg, device="meta", init_params=False, summary=False)
    for mod in model.net.modules():
        if isinstance(mod, Conv3d):
            mod.register_forward_hook(k1)
        elif isinstance(mod, ConvTranspose3d):
            mod.register_forward_hook(k2)
    x = torch.empty(batch, *cfg["input_spatial_dims"], cfg["input_channels"], device="meta")
    with torch.no_grad():
        model.net.detect(x, rng=torch.Generator())
    return sorted(seen)


@pytest.mark.parametrize("name,gflop,k2", [("cfg1", 60.50304, 4), ("prob", 127.301248, 8),
                                           ("prob_dense", 186.873472, 14)])
def test_counts_are_the_programs_operations(name, gflop, k2):
    """At the published widths the counted K1/K2 calls are the program's,
    call for call; a volume's GFLOP and its K2 launches."""
    cfg = _config(name)["model"]
    counted = counts_dense.detect_calls(cfg, 2, "bfloat16")
    assert sorted((c.kind, c.flops) for c in counted if c.kind in ("K1", "K2")) == \
        _program_calls(cfg, 2)
    assert abs(counts_m1.model_flops(counted) / 2e9 - gflop) < 1e-6
    assert counts_m1.launches(counted)["K2"] == k2


def test_the_stitch_k1s_take_2_to_6_parts(monkeypatch):
    """prob_dense's K1s over a part list, a first conv and a projection conv
    each: the decoder's over 2, 3, 4 and 5 parts, the ladder's over 3, 4, 5
    and 6. Those over 4 to 6 parts do 94.4 of a volume's 186.9 GFLOP."""
    seen, real = [], counts_m1._Counter.conv

    def spy(self, parts_c, *args, **kwargs):
        out = real(self, parts_c, *args, **kwargs)
        seen.append((len(parts_c), self.calls[-1].flops))
        return out

    monkeypatch.setattr(counts_m1._Counter, "conv", spy)
    counts_dense.detect_calls(PROB_DENSE["model"], 1, "bfloat16")
    parts = sorted(n for n, _ in seen if n > 1)
    assert parts == [2] * 2 + [3] * 4 + [4] * 4 + [5] * 4 + [6] * 2
    assert round(sum(f for n, f in seen if n >= 4) / 1e9, 1) == 94.4


def test_the_cell_agrees_in_fp32():
    r = run.run_cell("prob_dense_mc4_b8", SEED, 1.0, False, device="cpu",
                     overrides={"model": TINY, "workload": {"dtype": "float32"}})
    got = {c["name"]: c["value"] for c in r["checks"]}
    assert max(got.values()) < 1e-5, got
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("variant", ["alter_answer", "half_batch", "nan_answer"])
def test_a_fault_under_the_timed_path_is_not_correct(variant):
    """Each fault planted in the session comes out not correct; 2 volumes a
    request, as the other serve cells' fault tests have it (one answer of 8
    mixed up moves a request's mean gap by an eighth)."""
    r = run.run_cell("prob_dense_mc4_b8", SEED, 1.0, False, device="cpu", variant=variant,
                     overrides={"model": TINY, "workload": {"batch": 2}})
    assert r["correct"] is False, r["checks"]
