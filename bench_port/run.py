#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``, which names
its metrics, or a cell kept as files only (it reports ``setup_s`` and its
checks); its file ``bench_port/workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``) and its
traffic. The run builds the program's session or train step from the seed,
warms the cell's shapes (set-up), measures for ``--seconds`` (with
``--trace 1`` under the profiler, which the readers of the cell's per-layer
metrics, ``metrics/<metric>.py``, take), reads the device's peak memory,
frees the program's state and checks what the window produced against the
plain reference (``reference/``). The last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` ``breakdown``), then ``checks``, each
number compared with its limit; the same numbers close standard error.

It exits non-zero without a result where the card is missing or fewer
cards are present than the cell asks for, where the program is missing,
and where JAX or the JAX package is loaded in the process once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "prostatemr_3d_cad_cspca_tpu_torch"
# top-level module names that may not be loaded (compared whole: the
# program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "prostatemr_3d_cad_cspca_tpu")
# one process with few threads: the host's cores are shared, and the
# program's host work is one thread's (numpy, OpenMP and OpenCV pools held
# to one thread each; set before they load)
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "NUMEXPR_NUM_THREADS": "1", "OPENCV_FOR_THREADS_NUM": "1"}
# the caches of the run's libraries, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
              "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions")}


def fail(msg: str, code: int = 2):
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_spec(cell: str, bench=None):
    """(benchmark entry, workload file, config file, end-to-end metrics,
    per-layer metrics) of ``cell``."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry = [w for w in bench["workloads"] if w["name"] == cell]
    wl = load_json(HERE, "workloads", f"{cell}.json")
    if not entry:  # a cell kept as files only (PERF.md): no metric of it is named yet
        entry = [{"name": cell, "config": wl["config"], "chips": 1}]
    cfg = load_json(HERE, "configs", f"{entry[0]['config']}.json")

    def mine(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return entry[0], wl, cfg, e2e, layer


def strict(obj):
    """``obj`` for strict JSON: a number that is not finite (a gap read as
    inf) becomes its name as a string."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: strict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [strict(v) for v in obj]
    return obj


def device_info(torch, device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides=None, variant=None, t_start=None, bench=None) -> dict:
    """One run of ``cell``; returns the result object (the ``checks`` last).

    ``overrides``: {"model": {...}, "workload": {...}} merged over the
    files (the tests' small sizes). ``variant``: what replaces the program
    for the control and the fault tests (the driver's ``VARIANTS``)."""
    import torch

    from bench_port.harness.trace import Tracer

    t_start = T_START if t_start is None else t_start
    entry, wl, cfg, e2e, layer = cell_spec(cell, bench)
    overrides = overrides or {}
    wl = {**wl, **overrides.get("workload", {})}
    cfg = {**cfg, "model": {**cfg["model"], **overrides.get("model", {})}}
    dev = torch.device(device)
    driver = load_file(os.path.join(HERE, "drivers", f"{wl['driver']}.py"),
                       f"bench_port_driver_{wl['driver']}")
    run = driver.Cell(cfg, wl, int(seed), dev, variant=variant)
    run.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer() if trace else None
    window = run.window(seconds, tracer)
    device_block = device_info(torch, dev, int(entry["chips"]))
    result = {"correct": None, "attempted": window["attempted"], "failed": window["failed"]}
    metrics = {}
    if not trace:
        values = dict(run.end_to_end(window), setup_s=setup_s)
        for m in e2e:
            if m["name"] in values and values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        t_view = time.perf_counter()
        view = tracer.view(run.work(window))
        for m in layer:
            reader = load_file(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                               "bench_port_metric_" + m["name"].replace(".", "_"))
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_block.update(busy_s=view.busy_s, window_s=view.traced_s)
        result["breakdown"] = view.breakdown()
        print(f"bench_port: the trace read in {time.perf_counter() - t_view:.1f} s "
              f"({len(view.ops)} device operations)", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = device_block
    run.release()
    checks = run.check(window)
    result["correct"] = bool(checks) and window["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks)
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        fail(f"the program ({PROGRAM}) is not in this checkout")
    for k, v in {**CACHE_DIRS, **THREADS}.items():
        os.environ[k] = v
    os.environ["USE_FLAX"] = "0"  # transformers, where a library pulls it in
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = load_json(ROOT, "BENCHMARK.json")
    try:
        entry = cell_spec(args.workload, bench)[0]
    except (OSError, KeyError, ValueError) as e:
        fail(f"cell {args.workload!r}: {e}")
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        fail(f"the cell needs {entry['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present", 3)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        fail(f"loaded in the process that measured: {found}", 4)
    for c in result["checks"]:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(strict(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
