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


# ------------------------------------------------- K5's schedule (gemm_plan)
PROBE_CASES = [(gemm_rate.MM_SHAPE, gemm_rate.MM_ITERS)] + [
    (s, gemm_rate.LOOP_ITERS[0]) for s in gemm_rate.LOOP_SHAPES]
FEW_STEP_CASES = [(100, 40, 24, 3), (130, 16, 72, 4), (1, 8, 8, 1), (2560, 144, 128, 2)]


def _step_weight(plan, s):
    j = s // plan["iters"]
    return tgemm.K16 if j < plan["k_tiles"] - 1 else plan["last_k16"]


@pytest.mark.parametrize("m,k,n,iters", [(*s, it) for s, it in PROBE_CASES]
                         + FEW_STEP_CASES + [(200, 144, 136, 5), (640, 1152, 128, 3)])
def test_gemm_plan_covers_every_step_of_every_tile_once(m, k, n, iters):
    plan = tgemm.gemm_plan(m, k, n, iters)
    assert plan["steps"] == iters * plan["k_tiles"] == iters * -(-k // tgemm.BK)
    seen = {t: [] for t in range(plan["tiles"])}
    last_block = -1
    for b, t, s0, s1 in tgemm.plan_units(plan):
        assert b >= last_block and 0 <= s0 < s1 <= plan["steps"]
        last_block = b
        seen[t].append((s0, s1))
    for t, ranges in seen.items():  # in order, back to back, from 0 to steps
        assert ranges[0][0] == 0 and ranges[-1][1] == plan["steps"], (t, ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if plan["split"]:  # the reduce's view: first and last block of each tile
        units = tgemm.plan_units(plan)
        for t in range(plan["tiles"]):
            blocks = [b for b, tt, _, _ in units if tt == t]
            assert (plan["tile_first"][t], plan["tile_last"][t]) == (blocks[0], blocks[-1])
        slots = [b + t for b, t, _, _ in units]  # workspace slots, one a unit
        assert len(set(slots)) == len(slots)
        assert max(slots) < plan["workspace"] // (tgemm.BM * tgemm.BN)


@pytest.mark.parametrize("shape,iters", PROBE_CASES)
def test_gemm_plan_fills_the_card_at_the_probe_cases(shape, iters):
    plan = tgemm.gemm_plan(*shape, iters)
    assert plan["split"] and plan["blocks"] == tgemm.SMS
    units = tgemm.plan_units(plan)
    assert len(units) >= tgemm.SMS
    work = [0] * plan["blocks"]
    for b, _, s0, s1 in units:
        work[b] += sum(_step_weight(plan, s) for s in range(s0, s1))
    # equal work: each end of a range is snapped up by less than one step
    assert max(work) - min(work) < 2 * tgemm.K16
    assert sum(work) == plan["tiles"] * iters * (
        tgemm.K16 * (plan["k_tiles"] - 1) + plan["last_k16"])


@pytest.mark.parametrize("m,k,n,iters", FEW_STEP_CASES)
def test_gemm_plan_owns_each_tile_whole_where_its_steps_are_few(m, k, n, iters):
    plan = tgemm.gemm_plan(m, k, n, iters)
    assert not plan["split"] and plan["splits"] == 1 and plan["workspace"] == 0
    assert plan["blocks"] == plan["tiles"] == -(-m // tgemm.BM) * -(-n // tgemm.BN)


@pytest.mark.parametrize("m,k,n,iters", [
    (0, 8, 8, 1), (16, 12, 8, 1), (16, 8, 12, 1), (16, 0, 8, 1), (16, 8, 8, 0),
    (16, 8, 8, tgemm.MAX_ITERS + 1)])
def test_gemm_plan_refuses_what_the_kernel_does_not_take(m, k, n, iters):
    with pytest.raises(ValueError):
        tgemm.gemm_plan(m, k, n, iters)


def _emulate_gemm_loop(a, w, iters):
    """numpy replay of csrc/gemm_loop.cu from the int64 array the wrapper
    hands the C entry: each block walks its flat steps tile by tile, a slab
    at a time for all the iterations of its range, in chains of at most 32
    16-deep steps summed into the fp32 accumulator; a unit that covers its
    tile rounds it to bf16, the others leave partials in slot block + tile,
    which the reduce adds in block order and rounds once."""
    m, k = a.shape
    n = w.shape[1]
    meta = tgemm.gemm_meta(tgemm.gemm_plan(m, k, n, iters))
    _, _, _, it, tiles_n, tiles, k_tiles, last_k16, steps, blocks, split = meta[:11]
    sms = tgemm.SMS
    bm, bn, bk = tgemm.BM, tgemm.BN, tgemm.BK
    tiles_m = tiles // tiles_n
    ap = np.zeros((tiles_m * bm, k_tiles * bk), np.float64)
    wp = np.zeros((k_tiles * bk, tiles_n * bn), np.float64)
    ap[:m, :k], wp[:k, :n] = a, w  # TMA's zero fill
    out = np.full((tiles_m * bm, tiles_n * bn), np.nan, np.float32)
    slots = {}
    for b in range(blocks):
        g0, g1 = (meta[11 + b], meta[12 + b]) if split else (b * steps, (b + 1) * steps)
        g = g0
        while g < g1:
            t = g // steps
            s0, s1 = g - t * steps, min(g1, (t + 1) * steps) - t * steps
            rows, cols = slice(t // tiles_n * bm, (t // tiles_n + 1) * bm), \
                slice(t % tiles_n * bn, (t % tiles_n + 1) * bn)
            acc = np.zeros((bm, bn), np.float32)
            for j in range(s0 // it, (s1 - 1) // it + 1):
                reps = min(s1, (j + 1) * it) - max(s0, j * it)
                nk = last_k16 if j == k_tiles - 1 else tgemm.K16
                depth = slice(j * bk, j * bk + 16 * nk)
                prod = ap[rows, depth] @ wp[depth, cols]
                chain = 32 // nk
                for r0 in range(0, reps, chain):
                    acc += np.float32(min(reps - r0, chain) * prod)
            if s0 == 0 and s1 == steps:
                out[rows, cols] = acc
            else:
                slots[b + t] = acc
            g = (t * steps) + s1
    for t in range(tiles if split else 0):
        first, last = meta[12 + sms + t], meta[12 + 2 * sms + t]
        if first == last:
            continue
        rows, cols = slice(t // tiles_n * bm, (t // tiles_n + 1) * bm), \
            slice(t % tiles_n * bn, (t % tiles_n + 1) * bn)
        total = slots[first + t].copy()
        for b in range(first + 1, last + 1):
            total += slots[b + t]
        out[rows, cols] = total
    assert not np.isnan(out[:m, :n]).any(), "some output element belongs to no unit"
    return torch.from_numpy(out[:m, :n].copy()).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n,iters", [(200, 144, 136, 5), (130, 72, 16, 40),
                                         (640, 1152, 128, 3), (100, 40, 24, 3)])
def test_gemm_schedule_emulation_matches_the_plain_twin(m, k, n, iters):
    """The schedule the card walks (split where the plan splits) gives the
    plain twin's function to one bf16 rounding."""
    a, w = gemm_rate.operands(m, k, n, "cpu", seed=m + k + n)
    got = _emulate_gemm_loop(a.float().numpy(), w.float().numpy(), iters)
    _check_twin(got, tgemm.gemm_loop_plain(a, w, iters).float().numpy())


def test_gemm_meta_is_what_the_c_entry_reads():
    plan = tgemm.gemm_plan(640, 1152, 128, 200)
    meta = tgemm.gemm_meta(plan)
    assert meta.dtype == np.int64 and meta.shape == (tgemm.META_LEN,) == (408,)
    assert list(meta[:11]) == [640, 1152, 128, 200, 1, 5, 18, 4, 3600, 132, 1]
    assert tuple(meta[11:11 + 133]) == plan["starts"]
    assert tuple(meta[12 + 132:12 + 132 + 5]) == plan["tile_first"]
    assert tuple(meta[12 + 264:12 + 264 + 5]) == plan["tile_last"]
