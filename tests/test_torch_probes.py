"""K5's plain twin against the TPU GEMM-rate probe kernels themselves, and
the port's probe entry point on the CPU.

The Pallas kernels of ``benchmarks/r2_probe_pallas_mm2.py``
(``pallas_loop_mm``) and ``benchmarks/r2_probe_pallas_mxu.py``
(``mm_probe``) run here in interpret mode: each module's ``pl`` is swapped
for a namespace whose ``pallas_call`` interprets, and its timing helpers are
patched to capture the kernel's output instead (the benchmark files are only
imported, never edited). Tolerance: |diff| <= 2**-7 * max(1, |ref|), one
bf16 rounding of an fp32 sum taken in another order.
"""

import functools
import importlib
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch.ops import gemm as tgemm
from prostatemr_3d_cad_cspca_tpu_torch.probes import gemm_rate

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmarks")
BF16_ULP = 2.0 ** -7


def _probe_module(name, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    mod = importlib.import_module(name)
    shim = types.SimpleNamespace(**{k: getattr(mod.pl, k) for k in dir(mod.pl)
                                    if not k.startswith("__")})
    shim.pallas_call = functools.partial(mod.pl.pallas_call, interpret=True)
    monkeypatch.setattr(mod, "pl", shim)
    monkeypatch.setattr(mod, "report", lambda *a, **k: None)
    return mod


def _torch_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _check_twin(got, want):
    want = np.asarray(want, np.float32)
    diff = np.abs(got.float().numpy() - want)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (diff <= BF16_ULP * np.maximum(1.0, np.abs(want))).all(), diff.max()


@pytest.mark.parametrize("m,k,n,iters", [(32, 144, 16, 3), (48, 144, 24, 2),
                                         (32, 32, 8, 5)])
def test_plain_twin_matches_pallas_loop_mm(monkeypatch, m, k, n, iters):
    mod = _probe_module("r2_probe_pallas_mm2", monkeypatch)
    got = {}

    def slope(make_f, a, w, **_):
        got.update(out=jax.jit(make_f(iters))(a, w), a=a, w=w)
        return 1.0

    monkeypatch.setattr(mod, "_slope", slope)
    mod.pallas_loop_mm(m, k, n, jnp.bfloat16)
    out = tgemm.gemm_loop(_torch_bf16(got["a"]), _torch_bf16(got["w"]), iters)
    _check_twin(out, got["out"])


def test_plain_twin_matches_mm_probe(monkeypatch):
    """``mm_probe`` at LN=16: 640x144x16, its own 200 iterations."""
    mod = _probe_module("r2_probe_pallas_mxu", monkeypatch)
    monkeypatch.setattr(mod, "LN", 16)
    got = {}

    def timed(fn, *args):
        got.update(out=fn(*args), a=args[0], w=args[1])
        return 1.0

    monkeypatch.setattr(mod, "timed", timed)
    mod.mm_probe(jax.random.PRNGKey(0))
    assert got["a"].shape == (640, 144) and got["w"].shape == (144, 16)
    out = tgemm.gemm_loop_plain(_torch_bf16(got["a"]), _torch_bf16(got["w"]), 200)
    _check_twin(out, got["out"])


def test_cublas_yardstick_needs_a_card():
    a, w = gemm_rate.operands(16, 8, 8, "cpu")
    with pytest.raises(ValueError, match="card"):
        gemm_rate.cublas_loop(a, w, 2)


def test_wrapper_runs_the_plain_twin_on_cpu_tensors():
    a, w = gemm_rate.operands(40, 24, 16, "cpu")
    n0 = tgemm.gemm_loop.launches
    assert torch.equal(tgemm.gemm_loop(a, w, 3), tgemm.gemm_loop_plain(a, w, 3))
    assert tgemm.gemm_loop.launches == n0  # the CPU twin launches nothing


@pytest.mark.parametrize("a_shape,w_shape,iters", [
    ((4, 8), (16, 8), 1), ((4, 8, 1), (8, 8), 1), ((4, 8), (8, 8), 0)])
def test_wrapper_refuses_bad_arguments(a_shape, w_shape, iters):
    with pytest.raises(ValueError):
        tgemm.gemm_loop(torch.zeros(a_shape, dtype=torch.bfloat16),
                        torch.zeros(w_shape, dtype=torch.bfloat16), iters)


@pytest.mark.parametrize("argv,modes", [
    ([], ["mm", "loop", "conv"]), (["loop"], ["loop"]),
    (["conv", "mm", "conv"], ["conv", "mm"])])
def test_cli_parses_modes(argv, modes):
    args = gemm_rate.build_parser().parse_args(argv)
    assert (list(dict.fromkeys(args.modes)) or list(gemm_rate.MODES)) == modes
    assert args.DEVICE == "cuda"


def test_cli_refuses_unknown_modes():
    with pytest.raises(SystemExit):
        gemm_rate.build_parser().parse_args(["gemm"])


def test_cli_defaults_are_the_tpu_probes():
    assert gemm_rate.MM_ITERS == 200 and gemm_rate.LOOP_ITERS == (100, 800)
    assert gemm_rate.CONV_SHAPE == (64, 20, 160, 20, 128)
    assert gemm_rate.LOOP_SHAPES[0] == gemm_rate.MM_SHAPE == (640, 1152, 128)
    assert len(gemm_rate.LOOP_SHAPES) == 7
    with pytest.raises(SystemExit):  # the sizes are the probes', not options
        gemm_rate.build_parser().parse_args(["--MM_ITERS", "2"])


def test_cli_without_a_card_refuses_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gemm_rate.main(["mm"])


def test_cli_cpu_path_runs_every_mode(monkeypatch, capsys):
    """The CLI on the CPU, each mode's function cut to a few iterations and
    a small conv so that the plain twins finish quickly."""
    for name, kw in (("mm_probe", dict(iters=2)), ("loop_probe", dict(iters=(1, 2))),
                     ("conv_probe", dict(shape=(1, 2, 8, 6, 16)))):
        monkeypatch.setattr(gemm_rate, name,
                            functools.partial(getattr(gemm_rate, name), **kw))
    out = gemm_rate.main(["mm", "loop", "conv", "--DEVICE", "cpu"])
    assert out["mm"]["device"] == "cpu" and out["mm"]["shape"] == [640, 1152, 128]
    assert math.isfinite(out["mm"]["ms_per_iter"])
    assert [r["shape"] for r in out["loop"]] == [list(s) for s in gemm_rate.LOOP_SHAPES]
    assert all(r["library_ms_per_iter"] is None for r in out["loop"])
    assert out["conv"]["max_rel_err"] == 0.0  # the CPU path is the twin itself
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 + 7 + 1 and all('"device": "cpu"' in ln for ln in printed)
