"""The readers of the program's spans (``harness/spans.py`` and the
metrics whose files name ``NAMES``) on synthetic traces: each reads the
device ms inside its spans' ranges over the driver's units, counts an
operation inside two ranges once, and reads nothing where the program
opened none of its spans."""

import json
import os

import pytest

from bench_port import run
from bench_port.harness.spans import ms_per_unit, program_ms
from bench_port.harness.trace import TraceView, peaks

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
SPAN_METRICS = {
    "se_ms_per_request.serve": ("m1.se",),
    "gate_ms_per_request.serve": ("m1.gate",),
    "dropout_ms_per_request.serve": ("m1.dropout",),
    "mc_ms_per_request.serve": ("infer.mc_stack", "infer.mc_reduce"),
    "se_ms_per_forward.gland": ("m1.se",),
    "gate_ms_per_forward.gland": ("m1.gate",),
    "dropout_ms_per_forward.gland": ("m1.dropout",),
    "sw_ms_per_forward.gland": ("sw.gather", "sw.blend", "sw.finish", "tta.flip",
                                "ensemble.reduce"),
}


def _reader(name):
    return run.load_file(os.path.join(run.HERE, "metrics", f"{name}.py"), "m_" + name)


def _view(ops, ranges, units, window=(0.0, 1e6)):
    return TraceView(ops=ops, ranges=ranges, host=[], window=window,
                     work={"units": units, "calls": []}, peaks=peaks())


def _trace(names, units):
    """Each unit: a kernel of 100 us before the spans, then one span of each
    name holding two kernels (30 + 20 us), then a copy outside them."""
    ops, ranges, t = [], {}, 0.0
    for _ in range(units):
        ops.append(("conv3d_wgmma_kernel", t, t + 100.0))
        t += 105.0
        for n in names:
            ops += [("elementwise_kernel", t, t + 30.0), ("reduce_kernel", t + 31.0, t + 51.0)]
            ranges.setdefault(n, []).append((t, t + 51.0))
            t += 55.0
        ops.append(("Memcpy DtoH", t, t + 40.0))
        t += 45.0
    return ops, ranges, t


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reads_the_spans_device_ms_a_unit(name):
    names = SPAN_METRICS[name]
    assert _reader(name).NAMES == names
    ops, ranges, t = _trace(names, 3)
    got = _reader(name).read(_view(ops, ranges, 3, (0.0, t)))
    assert abs(got - 0.050 * len(names)) < 1e-12  # 50 us a name a unit


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_an_operation_inside_two_ranges_counts_once(name):
    """Ranges of several names (or one name's nested instances) that share
    an operation count it once; the reading is the union's."""
    names = SPAN_METRICS[name]
    ops = [("elementwise_kernel", 10.0, 40.0), ("reduce_kernel", 50.0, 70.0)]
    ranges = {n: [(5.0, 75.0)] for n in names}
    ranges[names[0]] = ranges[names[0]] + [(8.0, 45.0)]
    assert abs(_reader(name).read(_view(ops, ranges, 2)) - 0.025) < 1e-12


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_other_spans_and_operations_outside_are_not_read(name):
    names = SPAN_METRICS[name]
    ops, ranges, t = _trace(("m1.forward", "serve.readback", "augment"), 2)
    assert _reader(name).read(_view(ops, ranges, 2, (0.0, t))) is None
    ops2, ranges2, _ = _trace(names, 1)
    ranges2 = {n: [(s + 1e7, e + 1e7) for s, e in r] for n, r in ranges2.items()}
    assert _reader(name).read(_view(ops2, ranges2, 1)) is None  # outside the window


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_no_spans_or_no_units_read_nothing(name):
    ops, ranges, t = _trace(SPAN_METRICS[name], 2)
    assert _reader(name).read(_view(ops, {}, 2, (0.0, t))) is None
    assert _reader(name).read(_view(ops, ranges, 0, (0.0, t))) is None


def test_a_range_with_a_kernel_running_past_its_end_leaves_it_out():
    """A range ends where its last kernel ends on the device: a kernel that
    starts inside and ends past it belongs to no read span."""
    v = _view([("a", 0.0, 10.0), ("b", 12.0, 30.0)], {"m1.se": [(0.0, 20.0)]}, 1)
    assert abs(program_ms(v, ("m1.se",)) - 0.010) < 1e-12
    assert abs(ms_per_unit(v, ("m1.se",)) - 0.010) < 1e-12


def test_the_entries_name_their_cells_and_layers():
    """The span metrics' entries: device ms of one layer, moving the cells'
    end-to-end metric, in the cells whose traffic opens the spans."""
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, names in SPAN_METRICS.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "device_trace")
        model = all(n.startswith("m1.") for n in names)
        assert m["layer"] == ("model" if model else "serving")
        if name.endswith(".serve"):
            assert (m["moves"], m["workloads"]) == ("vol_per_s", ["cfg1_mc4_b8", "prob_mc4_b8"])
        else:
            assert (m["moves"], m["workloads"]) == ("case_s", ["cfg1_gland_fp32"])
