"""The serving layer's host<->device copies (``serve.HostCopies``).

On the CPU the copies run in their unpinned form (``HostCopies("cpu",
pin=False)`` put on a CPU session): the same upload and readback logic as
a CUDA session's, on host memory that is not pinned. Each path the serve
CLI drives must give the bits of the plain path (``.to(device)`` and
``.float().cpu().numpy()``, which a CPU session keeps), hand out results
that later calls leave alone, and count what crossed. The model is a
tiny cfg1-shaped M1 with MC dropout (one in bf16, whose outputs widen on
the device).

The tests marked ``cuda`` run the pinned path on a card against the
pageable one; they import no JAX, so on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_serve_copies.py
"""

import json
import os

import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch import serve
from prostatemr_3d_cad_cspca_tpu_torch.ensemble import M1Ensemble
from prostatemr_3d_cad_cspca_tpu_torch.models import M1
from prostatemr_3d_cad_cspca_tpu_torch.serve import COPY_COUNTS, HostCopies, InferenceSession
from test_torch_dist_util import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPATIAL = (4, 16, 16)
KW = dict(input_spatial_dims=SPATIAL, input_channels=3, num_classes=2,
          filters=(4, 8, 12, 16, 24),
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
          se_reduction=(2, 2, 2, 2, 2), summary=False, dropout_mode="monte-carlo",
          device="cpu")
CASE = (6, 24, 24, 3)  # larger than the window: sliding windows
# session options of each served path; "case" and "group" are whole cases
PATHS = {
    "mc": {}, "cascade": {}, "chunked": {"scan_chunk": 2},
    "foreground": {"transfer_channels": "foreground"},
    "float16": {"transfer_dtype": "float16"}, "case": {}, "group": {}, "bfloat16": {},
}


@pytest.fixture(scope="module")
def models():
    return {"single": M1(**KW, seed=0), "cascade": M1(**KW, seed=1, cascaded="noisy-or"),
            "bfloat16": M1(**KW, seed=2, dtype=torch.bfloat16)}


def _session(models, path, copies, seed=3):
    model = models[path if path in ("cascade", "bfloat16") else "single"]
    s = InferenceSession(model, mc_iter=2, seed=seed, device="cpu", **PATHS[path])
    if copies:  # the unpinned form of a CUDA session's copies
        s._copies = HostCopies("cpu", pin=False)
    return s


def _inputs(path, n):
    """The n-th call's host input: a batch of 3 (fp64, cast on the way up),
    a cascade's pair of exams, or whole cases."""
    rng = np.random.default_rng(n)
    if path in ("case", "group"):
        return [rng.normal(size=CASE).astype(np.float32) for _ in range(3)]
    batch = rng.normal(size=(3, *SPATIAL, 3))
    return (batch, rng.normal(size=batch.shape)) if path == "cascade" else batch


def _serve(session, path, x):
    """One call -> its arrays, in order."""
    if path == "case":
        return list(session.predict_case(x[0]))
    if path == "group":
        return [a for pair in session.predict_cases(x, group_size=2) for a in pair]
    return list(session(x))


@pytest.mark.parametrize("path", list(PATHS))
def test_host_copies_give_the_plain_paths_bits(models, path):
    """``HostCopies``' upload and readback return, call after call, the
    arrays the plain path returns: same dtype (fp32), same bits."""
    plain, copies = _session(models, path, False), _session(models, path, True)
    for n in range(2):
        want, got = _serve(plain, path, _inputs(path, n)), _serve(copies, path, _inputs(path, n))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)


@pytest.mark.parametrize("path", ["mc", "group"])
def test_results_survive_later_calls(models, path):
    """What call n returned is unchanged after calls n + 1 ... n + 3 on
    other inputs: no result shares host memory with a later one."""
    s = _session(models, path, True)
    first = _serve(s, path, _inputs(path, 0))
    kept = [a.copy() for a in first]
    for n in range(1, 4):
        later = _serve(s, path, _inputs(path, n))
        assert not any(np.shares_memory(a, b) for a in first for b in later)
    for a, k in zip(first, kept):
        assert np.array_equal(a, k)


def _out_bytes(path, dtype_bytes):
    """Bytes of one call's readback: the MC mean and std of 3 volumes, each
    channel of the two classes (one where the background is dropped)."""
    channels = 1 if path == "foreground" else 2
    return 2 * 3 * int(np.prod(SPATIAL)) * channels * dtype_bytes


@pytest.mark.parametrize("path,exams,down_item", [
    ("mc", 1, 4), ("cascade", 2, 4), ("foreground", 1, 4),
    # fp16 output crosses as fp16 and is widened on the host; the model's
    # own bf16 is widened on the device and crosses as fp32
    ("float16", 1, 2), ("bfloat16", 1, 4),
])
def test_copy_counts(models, path, exams, down_item):
    """Bytes up (pageable: the driver stages them) and down (through
    unpinned host memory here); a CPU session counts 0."""
    s, calls = _session(models, path, True), 3
    for n in range(calls):
        _serve(s, path, _inputs(path, n))
    up = calls * exams * 3 * int(np.prod(SPATIAL)) * 3 * 4  # fp32 on the way up
    assert s.copy_counts == {"up_pageable_bytes": up, "down_pinned_bytes": 0,
                             "down_pageable_bytes": calls * _out_bytes(path, down_item)}
    plain = _session(models, path, False)
    _serve(plain, path, _inputs(path, 0))
    assert plain._copies is None and plain.copy_counts == dict.fromkeys(COPY_COUNTS, 0)


def test_group_counts_its_cases_not_its_padding(models):
    """3 cases in groups of 2: two uploads of 2 cases (the last padded with
    a copy), and only the 3 real cases' mean and std back."""
    s = _session(models, "group", True)
    _serve(s, "group", _inputs("group", 0))
    vol = int(np.prod(CASE[:-1]))
    assert s.copy_counts["up_pageable_bytes"] == 2 * 2 * vol * 3 * 4
    assert s.copy_counts["down_pageable_bytes"] == 3 * vol * 2 * 2 * 4


def test_upload_casts_and_stacks_as_the_plain_path():
    """numpy arrives as ``np.ascontiguousarray(x, np.float32)`` (negative
    strides too), a list of rows as their stack, a CPU tensor in its own
    dtype."""
    c = HostCopies("cpu", pin=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 4))
    flipped = rng.normal(size=(3, 3, 4))[::-1]
    for a in (x, flipped):
        got = c.upload(a)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.ascontiguousarray(a, np.float32))
    rows = [rng.normal(size=(3, 4)) for _ in range(2)]
    assert np.array_equal(c.upload(rows).numpy(), np.stack(rows).astype(np.float32))
    t = torch.from_numpy(x)
    got = c.upload(t)
    assert got.dtype == torch.float64 and torch.equal(got, t)


def test_the_session_path_follows_the_device(models):
    """A CPU session keeps the plain path; the pinned path is the CUDA
    device's alone (no option chooses it)."""
    s = InferenceSession(models["single"], mc_iter=2, seed=3, device="cpu")
    assert s._copies is None and HostCopies("cuda").pin


def test_copy_spans_carry_the_counts(models, monkeypatch):
    """``serve.upload`` and ``serve.readback`` carry the session's counts as
    they stand when the span opens."""
    seen = []
    real = serve.annotate

    def recording(name, args=None):
        if name in ("serve.upload", "serve.readback"):
            seen.append((name, dict(args)))
        return real(name, args)

    monkeypatch.setattr(serve, "annotate", recording)
    s = _session(models, "mc", True)
    s(_inputs("mc", 0))
    s(_inputs("mc", 1))
    ups = [a for n, a in seen if n == "serve.upload"]
    backs = [a for n, a in seen if n == "serve.readback"]
    assert len(ups) == len(backs) == 2
    assert ups[0] == dict.fromkeys(COPY_COUNTS, 0)
    assert backs[0]["up_pageable_bytes"] > 0 == backs[0]["down_pageable_bytes"]
    assert ups[1]["down_pageable_bytes"] == _out_bytes("mc", 4)


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned path is the CUDA session's")
    return torch.device("cuda")


def _cfg1(**over):
    with open(os.path.join(ROOT, "bench_port", "configs", "cfg1.json")) as fh:
        model = json.load(fh)["model"]
    return {**model, "summary": False, "device": "cuda", **over}


def _owner(a):
    """The object that owns a returned array's memory."""
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a.base


def _card_sessions(which):
    """Two sessions of one model and seed: the pinned path and the pageable
    one (the plain path on the card), and each call's host input."""
    if which == "request":  # the cfg1_mc4_b8 cell's request: bf16, MC 4, 8 volumes
        model, opts = M1(**_cfg1(dtype=torch.bfloat16), seed=0), dict(mc_iter=4)
        shape = (8, *model.input_spatial_dims, 3)

        def call(s, n):
            return list(s(np.random.default_rng(n).normal(size=shape).astype(np.float32)))
    else:  # a small gland group: fp32, flip TTA, 2 members, MC 2, 2 cases
        model = M1Ensemble([M1(**_cfg1(), seed=m) for m in range(2)])
        opts = dict(mc_iter=2, tta=True)

        def call(s, n):
            rng = np.random.default_rng(n)
            cases = [rng.normal(size=(24, 192, 192, 3)).astype(np.float32) for _ in range(2)]
            return [a for pair in s.predict_cases(cases, group_size=2) for a in pair]
    pinned, pageable = (InferenceSession(model, seed=7, device="cuda", **opts) for _ in range(2))
    pageable._copies = None
    return pinned, pageable, call


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["request", "group"])
def test_card_pinned_readback_gives_the_pageable_bits_and_keeps_results(cuda_device, which):
    """On the card: every returned array lives in pinned memory and holds
    the pageable path's bits; what call 1 returned is unchanged after calls
    2-4; every call moves the same bytes, none down through pageable
    memory (the request's bf16 MC mean and std cross as fp32)."""
    pinned, pageable, call = _card_sessions(which)
    first = call(pinned, 0)
    assert all(np.array_equal(a, b) for a, b in zip(first, call(pageable, 0)))
    assert all(torch.is_tensor(_owner(a)) and _owner(a).is_pinned() for a in first)
    kept = [a.copy() for a in first]
    warm = dict(pinned.copy_counts)
    for n in range(1, 4):
        got, want = call(pinned, n), call(pageable, n)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a, k) for a, k in zip(first, kept))
    counts = pinned.copy_counts
    assert counts["down_pageable_bytes"] == 0
    assert counts["up_pageable_bytes"] == 4 * warm["up_pageable_bytes"] > 0
    assert counts["down_pinned_bytes"] == 4 * warm["down_pinned_bytes"] > 0
    if which == "request":
        assert warm["down_pinned_bytes"] == 2 * 8 * 20 * 160 * 160 * 2 * 4
