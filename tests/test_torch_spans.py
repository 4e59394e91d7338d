"""The port's spans (``utils/profiling.annotate``) on the CPU: where they
open and how they nest in an MC request and a sliding-window group, that
they cost no ``record_function`` and change no output with the profiler
off, and that every span is read by a metric of the benchmark
(``bench_port/metrics``) or names the device's idle gaps.

The model is a tiny cfg1-shaped M1 (filters 4/8/12/16/24, the bench cfg1
strides, MC dropout), so a forward opens cfg1's 8 SE tails, 4 gates and 8
dropouts, and 8 convs over a part list (its 4 decoder stitches, a first and
a projection conv each); the dense one is the bench prob_dense at those
widths (the probabilistic ladder over dense skips), whose forward adds the
6 up-chain transposed convs and 16 convs over 2 to 6 parts.
"""

import ast

import glob
import importlib.util
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prostatemr_3d_cad_cspca_tpu_torch.ensemble import M1Ensemble
from prostatemr_3d_cad_cspca_tpu_torch.models import M1
from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession
from prostatemr_3d_cad_cspca_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPATIAL = (4, 16, 16)
KW = dict(input_spatial_dims=SPATIAL, input_channels=3, num_classes=2,
          filters=(4, 8, 12, 16, 24),
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
          se_reduction=(2, 2, 2, 2, 2), summary=False, dropout_mode="monte-carlo",
          device="cpu")
KW_DENSE = dict(KW, input_channels=4, probabilistic=True, prob_latent_dims=(3, 2, 1, 0),
                dense_skip=True, deep_supervision=True)
CASE = (6, 24, 24, 3)  # 8 tiles of the window: 2 chunks of 4
# spans read by no metric file: host intervals that name the device's idle
# gaps (the trace's breakdown takes the innermost host event over a gap)
GAP_SPANS = {"serve.request", "serve.group", "serve.upload", "serve.forward",
             "serve.readback", "m1.forward"}
INFERENCE_SPANS = ("sw.gather", "sw.blend", "sw.finish", "tta.flip", "ensemble.reduce",
                   "infer.mc_stack", "infer.mc_reduce")


def _request_session():
    return InferenceSession(M1(**KW, seed=0), mc_iter=2, seed=3, device="cpu")


def _group_session():
    ens = M1Ensemble([M1(**KW, seed=0), M1(**KW, seed=1)])
    return InferenceSession(ens, mc_iter=2, seed=3, tta=True, device="cpu")


def _dense_session():
    return InferenceSession(M1(**KW_DENSE, seed=0), mc_iter=2, seed=3, device="cpu")


def _batch(channels=3):
    x = np.random.default_rng(0).normal(size=(2, *SPATIAL, channels)).astype(np.float32)
    x[..., 3:] = 0.0  # a probabilistic net's label channel at test time
    return x


def _cases():
    return [np.random.default_rng(i).normal(size=CASE).astype(np.float32) for i in range(2)]


def _spans(run):
    """``run()``'s result and its program spans (name, start, end, args)
    under a CPU profile, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name in profiling.SPANS),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.fixture(scope="module")
def request_spans():
    return _spans(lambda: _request_session()(_batch()))[1]


@pytest.fixture(scope="module")
def group_spans():
    return _spans(lambda: _group_session().predict_cases(_cases()))[1]


@pytest.fixture(scope="module")
def dense_spans():
    return _spans(lambda: _dense_session()(_batch(4)))[1]


RUNS = {"request": lambda: _request_session()(_batch()),
        "group": lambda: _group_session().predict_cases(_cases()),
        "dense": lambda: _dense_session()(_batch(4))}


@pytest.mark.parametrize("child,parent", [
    ("serve.upload", "serve.request"), ("serve.forward", "serve.request"),
    ("serve.readback", "serve.request"), ("infer.mc_stack", "serve.forward"),
    ("m1.forward", "serve.forward"), ("infer.mc_reduce", "serve.forward"),
    ("m1.se", "m1.forward"), ("m1.gate", "m1.forward"), ("m1.dropout", "m1.forward"),
])
def test_request_spans_nest(request_spans, child, parent):
    """An MC request: serve.request holds upload, forward and readback, the
    forward holds the MC stack, the model call and the MC reduction."""
    (outer,) = _named(request_spans, parent)
    kids = _named(request_spans, child)
    assert kids and all(_inside(k, outer) for k in kids)


def test_request_spans_come_in_order(request_spans):
    order = ["serve.request", "serve.upload", "serve.forward", "infer.mc_stack",
             "m1.forward", "infer.mc_reduce", "serve.readback"]
    firsts = [_named(request_spans, n)[0][1] for n in order]
    assert firsts == sorted(firsts)
    assert len(_named(request_spans, "m1.forward")) == 1


@pytest.mark.parametrize("name,count", [("m1.se", 8), ("m1.gate", 4), ("m1.dropout", 8),
                                        ("m1.stitch", 8), ("m1.dense", 0)])
@pytest.mark.parametrize("which", ["request", "group"])
def test_each_forward_holds_the_model_parts(request_spans, group_spans, which, name, count):
    """cfg1's wiring: 8 SE blocks, 4 attention gates, 8 active dropouts
    (the last at half the rate) in every detect-head call."""
    spans = request_spans if which == "request" else group_spans
    forwards = _named(spans, "m1.forward")
    assert forwards
    parts = _named(spans, name)
    assert len(parts) == count * len(forwards)
    for f in forwards:
        assert sum(_inside(p, f) for p in parts) == count


@pytest.mark.parametrize("name,count", [("m1.dense", 6), ("m1.stitch", 16), ("m1.se", 12),
                                        ("m1.gate", 4), ("m1.dropout", 12)])
def test_a_dense_forward_holds_its_up_chains_and_stitches(dense_spans, name, count):
    """The probabilistic ladder over dense skips, its detect head: the
    prior's trunk (8 SE blocks, 4 gates, 8 dropouts, the 6 up-chain
    transposed convs, 4 stitches) and its sampling ladder (4 SE blocks over
    3 to 6 parts, 4 dropouts); a stitch opens its span at the first and the
    projection conv."""
    forwards = _named(dense_spans, "m1.forward")
    assert len(forwards) == 1
    parts = _named(dense_spans, name)
    assert len(parts) == count and all(_inside(p, forwards[0]) for p in parts)


def _stitch_args(monkeypatch, run):
    """The ``args`` of every ``m1.stitch`` span of ``run()`` under a
    profile, as (parts, input channels)."""
    args, real = [], torch.profiler.record_function

    def recording(name, arg=None):
        if name == "m1.stitch":
            a = ast.literal_eval(arg)
            args.append((a["parts"], a["cin"]))
        return real(name, arg)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    _spans(run)
    return sorted(args)


@pytest.mark.parametrize("which", ["request", "dense"])
def test_stitch_spans_carry_their_parts_and_channels(monkeypatch, which):
    """Each stitch span names its part count and input channels (filters
    4/8/12/16/24): cfg1's decoder stitches 2 parts of f[i]; the dense
    trunk's 2 to 5 and the ladder's 3 to 6 (its upsampled features, then
    the trunk's stitch), each at the block's first and projection conv."""
    f = KW["filters"]
    if which == "request":
        want = [(2, 2 * f[i]) for i in range(4)]
    else:
        trunk = [(5 - i, (5 - i) * f[i]) for i in range(4)]
        ladder = [(1 + n, f[i] + c) for i, (n, c) in enumerate(trunk)]
        want = trunk + ladder
    assert _stitch_args(monkeypatch, RUNS[which]) == sorted(want * 2)


@pytest.mark.parametrize("name", INFERENCE_SPANS)
def test_group_inference_spans_enclose_no_model_call(group_spans, name):
    """A 2-case group with flip TTA over a 2-member ensemble opens every
    inference span, inside the group's forward, and none holds a model
    call: their device time is never the model's."""
    (group,) = _named(group_spans, "serve.group")
    (forward,) = _named(group_spans, "serve.forward")
    assert _inside(forward, group)
    found = _named(group_spans, name)
    assert found and all(_inside(s, forward) for s in found)
    models = _named(group_spans, "m1.forward")
    assert len(models) == 2 * 2 * 2  # chunks x views x members
    assert not any(_inside(m, s) for s in found for m in models)


@pytest.mark.parametrize("which", ["request", "group", "dense"])
def test_no_record_function_with_the_profiler_off(monkeypatch, which):
    """Untraced, ``annotate`` hands out its shared no-op context and never
    builds a ``record_function``; traced, one a span."""
    made = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        made.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    run = RUNS[which]
    run()
    assert made == []
    assert profiling.annotate("m1.se") is profiling.annotate("serve.request", 3)
    _, spans = _spans(run)
    assert sorted(made) == sorted(s[0] for s in spans)


@pytest.mark.parametrize("which", ["request", "group", "dense"])
def test_outputs_are_bitwise_equal_traced_and_not(which):
    """The spans change no operation and no draw: a session of one seed
    gives the same bits with the profiler on and off."""
    if which != "group":
        off = RUNS[which]()
        on, _ = _spans(RUNS[which])
        pairs = [(off, on)]
    else:
        off = _group_session().predict_cases(_cases())
        on, _ = _spans(lambda: _group_session().predict_cases(_cases()))
        pairs = list(zip(off, on))
    for a, b in pairs:
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _metric_names():
    """{metric file: the span names it reads}: a reader's ``NAMES``, or the
    names it passes to ``range_seconds``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "bench_port", "metrics", "*.py"))):
        src = open(path).read()
        names = set(re.findall(r'range_seconds\("([^"]+)"\)', src))
        if "NAMES" in src:
            spec = importlib.util.spec_from_file_location("span_metric", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            names |= set(mod.NAMES)
        if names:
            out[os.path.basename(path)] = names
    return out


def test_every_span_is_read():
    """Each name a metric reads is a span the program opens; each span is
    read by a metric, or is a host span that names idle gaps."""
    by_file = _metric_names()
    read = set().union(*by_file.values())
    assert read <= set(profiling.SPANS), read - set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))
    assert set(profiling.SPANS) == read | GAP_SPANS and not read & GAP_SPANS
    assert by_file["augment_ms_per_step.train.py"] == {"augment"}
