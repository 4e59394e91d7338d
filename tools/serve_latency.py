#!/usr/bin/env python3
"""Request latency of the port's bf16 serving on one GPU, over many
requests in one process: at cfg1 width the deterministic model, the CLI's
default MC model (dropout 0.5, ``mc_iter`` 4), cfg2, the probabilistic
README model (``mc_iter`` 4) and the noisy-or cascade (``chip_smoke.py``'s
configurations), 2 volumes a request, weights drawn by numpy from a seed as
``chip_smoke.py`` draws them.

    python3 tools/serve_latency.py [--requests 41] [--seed 0]

Run it from the root of a checkout (it uses that checkout's package and
``chip_smoke.py``). To compare two versions, unpack one into a directory of
the other and run the script from each root in turns, on one card:
A, B, A, B. Prints one JSON line: the median, 10th and 90th percentile,
least and most host-clock latency (ms) of requests 2..N of each model.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=41)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serve_latency: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    out = {"checkout": os.getcwd(), "card": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, overrides, mc_iter in (
                ("mc", dict(dropout_mode="monte-carlo", dropout_rate=0.5), chip_smoke.MC_ITER),
                ("deterministic", {}, 1),
                ("cfg2", chip_smoke.CFG2, 1),
                ("prob", chip_smoke.PROB, chip_smoke.MC_ITER),
                ("cascade", chip_smoke.CASCADE, 1)):
            cfg = {**chip_smoke.CFG1, **overrides}
            requests = chip_smoke._requests(args.seed, cfg["input_channels"])
            if cfg.get("cascaded"):  # two exams a volume
                requests = list(zip(requests, chip_smoke._requests(args.seed + 10)))
            ckpt = os.path.join(tmp, f"{name}.npz")
            chip_smoke.write_cfg1_checkpoint(ckpt, args.seed, **overrides)
            session = InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                                       mc_iter=mc_iter, seed=args.seed, device="cuda")
            latencies = []
            for i in range(args.requests):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                session(requests[i % len(requests)])
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
            steady = sorted(latencies[1:])
            n = len(steady)
            out[name] = {"median_ms": steady[n // 2], "p10_ms": steady[n // 10],
                         "p90_ms": steady[9 * n // 10], "min_ms": steady[0],
                         "max_ms": steady[-1], "requests": n}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
