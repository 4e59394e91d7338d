"""The per-layer readers on synthetic traces: a share of a roofline or of
the peak stays at or under 100 % where the kernels take at least the least
time; nothing to read gives nothing."""

import json
import os

import pytest

from bench_port import run
from bench_port.counts import m1
from bench_port.harness.trace import TraceView, peaks

CFG1 = json.load(open(os.path.join(run.HERE, "configs", "cfg1.json")))["model"]
# every reader, those of the cells kept for later too
NAMES = sorted(f[:-3] for f in os.listdir(os.path.join(run.HERE, "metrics")) if f.endswith(".py"))
KERNELS = {"K1": "conv3d_wgmma_kernel", "K2": "conv3d_wgmma_kernel", "K3": "in_stats_kernel",
           "K4": "in_apply_kernel", "K6": "wgrad_wgmma_kernel", "K7": "in_bwd_apply_kernel"}


def _view(calls, units, slack, gap_us=5.0):
    """A trace in which each call's kernel takes ``slack`` times its least
    time, back to back with ``gap_us`` between them."""
    p = peaks()
    ops, t = [], 0.0
    for _ in range(units):
        for c in calls:
            rate = (p["tensor_flop_per_s"][c.dtype] if c.kind in ("K1", "K2", "K6")
                    else p["vector_flop_per_s"])
            least = max(c.flops / rate, c.bytes / p["hbm_bytes_per_s"]) * 1e6
            ops.append((KERNELS[c.kind], t, t + least * slack))
            t += least * slack + gap_us
        ops.append(("Memcpy HtoD", t, t + 100.0))
        t += 100.0 + gap_us
    return TraceView(ops=ops, ranges={"augment": [(0.0, t)]}, host=[],
                     window=(0.0, t), work={"units": units, "calls": calls}, peaks=p)


def _reader(name):
    return run.load_file(os.path.join(run.HERE, "metrics", f"{name}.py"), "m_" + name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("slack", [1.0, 1.5, 40.0])
def test_shares_stay_under_100(name, slack):
    train = name.endswith(".train")
    calls = (m1.train_calls if train else m1.detect_calls)(CFG1, 2, "float32")
    value = _reader(name).read(_view(calls, 3, slack))
    assert value is not None and value > 0
    if name.split(".")[0].endswith(("roofline", "share")) or "mfu" in name:
        assert value <= 100.0 + 1e-9


@pytest.mark.parametrize("name", ["conv_roofline.serve", "norm_roofline.serve",
                                  "wgrad_roofline.train"])
def test_a_roofline_at_the_least_time_reads_100(name):
    calls = (m1.train_calls if name.endswith(".train") else m1.detect_calls)(CFG1, 2, "bfloat16")
    assert abs(_reader(name).read(_view(calls, 2, 1.0)) - 100.0) < 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_nothing(name):
    v = TraceView(ops=[], ranges={}, host=[], window=(0.0, 1e6),
                  work={"units": 0, "calls": []}, peaks=peaks())
    assert _reader(name).read(v) is None


def test_mfu_leaves_out_the_padding_share():
    calls = m1.detect_calls(CFG1, 2, "float32")
    whole = _view(calls, 3, 1.5)
    padded = _view(calls, 3, 1.5)
    padded.work["model_share"] = 0.9
    mfu = _reader("mfu.gland")
    assert abs(mfu.read(padded) - 0.9 * mfu.read(whole)) < 1e-9
