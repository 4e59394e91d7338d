"""Export: one self-contained inference artifact of a trained M1, port of
the JAX package's ``export.py``.

The reference deploys its trained models as a frozen container; the JAX
package lowers the whole detect program (Monte-Carlo sampling, flip TTA, a
fold ensemble, a cascade's composition) to StableHLO with the weights
inside. The port freezes the same program with ``torch.export``: one traced
graph with the weights inside, saved to one file. Deployment needs torch and
the port's ops, whose K1-K4 are registered operators (``pmr::conv3d``,
``pmr::conv3d_transpose``, ``pmr::in_stats``, ``pmr::in_apply``:
``ops/cuda_lib.register_op``) that launch the kernels on the card and run
their plain twins on the CPU, but no model code: the counterpart of a JAX
artifact needing jax and a platform plugin. A program traced on one device
runs on the other (``ExportedModel.load`` moves it). The batch dimension is
symbolic by default, so one artifact serves any batch size. AOTInductor is
not used: it would compile the plain ops that the kernels replace.

Artifact format, a zip archive:
  ``program.pt2``  ``torch.export.save`` of the detect program
  ``sw{i}.pt2``    one sliding-window program per case geometry, its case
                   axis symbolic
  ``meta.json``    the JAX package's keys (input signature, mc_iter, TTA,
                   ensemble, output layout, the model's config), plus
                   ``draws`` (the draw plan), ``dtype`` (the program's
                   compute type), ``traced_on`` and ``torch``.

Random draws are inputs. A ``torch.Generator`` traced into a program would
be frozen as a constant, and ``prng.fold_in`` derives its seeds on the host,
so a stochastic program takes each dropout site's uniforms and each sampling
level's normal ``eps`` as tensors (``prng.Draws``). The draw plan lists them
in the forward's order, each with its fold path (e.g. [view, member] under
TTA and an ensemble, [chunk] in a sliding window), its site, its kind
(uniform or normal), its dtype and its shape with the batch axis symbolic
(``"4*b"``: four MC samples stacked on the batch). ``ExportedModel`` redraws
them from ``prng.generator(seed)`` and ``fold_in`` as a live
``serve.InferenceSession`` with the same seed draws them: the same seed
gives the same bits.

Output contract, as ``serve.InferenceSession``:
  deterministic          probs                       (B,D,H,W,nc)
  stochastic, mc_iter=1  probs (one posterior draw)  (B,D,H,W,nc)
  stochastic, mc_iter>1  (mean, std) over draws      2x(B,D,H,W,nc)
  cascaded               the final stage's detection; the exams stacked on
                         the channel axis of the one input array.
The program computes in the model's dtype; its outputs are fp32, or
``transfer_dtype``.

CLI:
  python -m prostatemr_3d_cad_cspca_tpu_torch.export \\
      --MODEL weights/F1/model_weights_250.npz --OUT m1.zip [--MC_ITER 4] \\
      [--TTA 1] [--SW_SHAPE 24 256 256] [--DTYPE bfloat16] [--DEVICE cuda]
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import prng
from .device import resolve_device
from .infer import make_sliding_window_fn, mc_predict, tree_map

__all__ = ["export_model", "ExportedModel", "validate_artifact"]

_FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")  # where a program runs: the operators' implementations


def _detect_parts(model, tta: bool):
    """The (possibly TTA-wrapped) detect head and the cascade and rng facts
    both heads branch on."""
    detect = model.get_detect_model()
    if tta:
        from .ensemble import tta_detect

        detect = tta_detect(detect)
    needs_rng = bool(model.probabilistic
                     or model.config.get("dropout_mode") == "monte-carlo")
    return detect, bool(model.cascaded), int(model.input_channels), needs_rng


def _detect_head(model, mc_iter: int, tta: bool):
    """``(fn, needs_rng)``: ``fn(x, rng=None)`` is ``serve.InferenceSession``'s
    forward on ONE input tensor (a cascade's exams stacked on channels)."""
    detect, casc, c, needs_rng = _detect_parts(model, tta)

    def split(x):
        return (x[..., :c], x[..., c:]) if casc else x

    if needs_rng and mc_iter > 1:
        def fn(x, rng=None):
            mean, std = mc_predict(detect, None, split(x), rng, num_samples=mc_iter,
                                   reduce="mean_std")
            return (mean[-1], std[-1]) if casc else (mean, std)
    else:
        def fn(x, rng=None):
            out = detect(None, split(x), rng=rng) if needs_rng else detect(None, split(x))
            return out[-1] if casc else out
    return fn, needs_rng


def _tile_head(model, mc_iter: int, tta: bool):
    """The tile forward of a sliding window, as ``serve.InferenceSession.
    _sw_program`` composes it: MC mean and std concatenated on channels
    (out_mult 2), a cascade's exams stacked on channels. Returns
    ``(tile_fn, needs_rng, out_mult)``."""
    detect, casc, c, needs_rng = _detect_parts(model, tta)

    def fwd(tiles, rng=None):
        inp = (tiles[..., :c], tiles[..., c:]) if casc else tiles
        out = detect(None, inp, rng=rng) if needs_rng else detect(None, inp)
        return out[-1] if casc else out

    if needs_rng and mc_iter > 1:
        def tile_fn(tiles, rng):
            mean, std = mc_predict(lambda _p, x, rng: fwd(x, rng), None, tiles, rng,
                                   num_samples=mc_iter, reduce="mean_std")
            return torch.cat([mean, std], dim=-1)
        return tile_fn, True, 2
    if needs_rng:
        return fwd, True, 1
    return (lambda tiles: fwd(tiles)), False, 1


def _sliding_window(model, tile_fn, tile_rng, out_mult, shape, cin, overlap, out_dtype):
    """The K-case sliding window of ``shape`` (K any; built for 2 as JAX's)."""
    return make_sliding_window_fn(
        tile_fn, full_spatial=tuple(shape), window=tuple(model.input_spatial_dims),
        in_channels=cin, out_channels=int(model.num_classes) * out_mult,
        overlap=float(overlap), cases=2, rng_per_chunk=tile_rng, out_dtype=out_dtype)


class _Program(nn.Module):
    """What ``torch.export`` traces: the model's networks (their weights
    become the program's) and ``fn(x, rng)`` with, under a draw plan, the
    draws given as the second input; outputs cast to ``out_dtype``."""

    def __init__(self, model, fn, plan, out_dtype):
        super().__init__()
        self.nets = nn.ModuleList([m.net for m in getattr(model, "members", [model])])
        self.fn, self.plan, self.out_dtype = fn, plan, out_dtype

    def forward(self, x, draws=None):
        if self.plan is None:
            out = self.fn(x)
        else:
            out = self.fn(x, prng.Draws(prng.DrawReplay(self.plan, draws)))
        return tree_map(lambda t: t.to(self.out_dtype), out)


def _record(fn, x):
    """One eager call of ``fn`` that draws as the live forward does; returns
    the draw plan and the draws (the trace's example inputs)."""
    rec = prng.DrawRecorder(prng.generator(0, x.device))
    with torch.no_grad():
        fn(x, prng.Draws(rec))
    return rec.plan, rec.draws


def _symbolic(plan, n: int, sym: str):
    """The plan with each draw's leading (stacked batch) axis written as a
    multiple of the symbol ``sym`` of the traced batch ``n``."""
    out = []
    for e in plan:
        lead = e["shape"][0]
        if lead % n:
            raise ValueError(f"draw {e['site']} of shape {e['shape']} does not scale "
                             f"with the batch {n}")
        out.append(dict(e, shape=[f"{lead // n}*{sym}", *e["shape"][1:]]))
    return out


def _mult(entry) -> int:
    """How many times the batch a draw's leading axis is ("4*b" -> 4)."""
    return int(entry["shape"][0].split("*")[0])


def _draw_shapes(plan, n: int):
    """Each draw's shape at batch (or case count) ``n``."""
    return [(_mult(e) * n, *e["shape"][1:]) for e in plan]


def _trace(model, fn, x, needs_rng, out_dtype, batch, sym):
    """``torch.export`` of ``fn`` on the example ``x`` (its leading axis
    symbolic as ``sym`` unless ``batch`` fixes it). Returns the exported
    program and the draw plan (None without draws)."""
    from torch.export import Dim, export

    plan, draws = _record(fn, x) if needs_rng else (None, None)
    n = int(x.shape[0])
    if plan is not None:
        plan = _symbolic(plan, n, sym)
    program = _Program(model, fn, plan, out_dtype)
    args = (x,) if plan is None else (x, draws)
    dynamic = None
    if batch is None:
        dim = Dim(sym, min=1)
        dynamic = ({0: dim},)
        if plan is not None:
            dynamic += ([{0: dim if _mult(e) == 1 else _mult(e) * dim} for e in plan],)
    with torch.no_grad():
        return export(program, args, dynamic_shapes=dynamic, strict=False), plan


def _save(ep) -> bytes:
    """The program's bytes, without the trace's example inputs (the zero
    input and, in a stochastic program, every draw: hundreds of MB at cfg1
    width)."""
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_model(
    model,
    path: str,
    *,
    mc_iter: int = 1,
    tta: bool = False,
    batch: Optional[int] = None,
    transfer_dtype: Optional[str] = None,
    sw_shapes: Optional[Sequence[Sequence[int]]] = None,
    sw_overlap: float = 0.5,
) -> str:
    """Freeze ``model``'s inference program (weights included) to ``path``.

    model: an ``M1`` or ``ensemble.M1Ensemble`` (any class: deterministic,
        MC-dropout, probabilistic, cascaded); traced on its device in its
        dtype.
    mc_iter: >1 bakes mean/std Monte-Carlo aggregation into the program
        (stochastic models only), one forward of the samples stacked on the
        batch.
    tta: fuse axial flip test-time augmentation (``ensemble.tta_detect``).
    batch: fixed batch size, or None for a symbolic batch dimension.
    transfer_dtype: e.g. "float16": the program's outputs in that type
        (quantizes probabilities by <= ~5e-4).
    sw_shapes: case geometries (D, H, W) larger than the window; for each, a
        Gaussian-blended sliding-window program (``infer.
        make_sliding_window_fn``: tile gather, forwards, blended scatter)
        with a symbolic case axis, served by ``ExportedModel.predict_cases``.
    sw_overlap: tile overlap fraction of the sliding-window programs.
    """
    dev = torch.device(model.device)
    out_dtype = getattr(torch, transfer_dtype) if transfer_dtype else torch.float32
    spatial = tuple(int(d) for d in model.input_spatial_dims)
    cin = int(model.input_channels) * (2 if model.cascaded else 1)
    head, needs_rng = _detect_head(model, mc_iter, tta)
    x = torch.zeros((int(batch or 2), *spatial, cin), device=dev)
    ep, plan = _trace(model, head, x, needs_rng, out_dtype, batch, "b")
    blobs = {"program.pt2": _save(ep)}

    sw_meta = []
    if sw_shapes:
        tile_fn, tile_rng, out_mult = _tile_head(model, mc_iter, tta)
    for i, shp in enumerate(sw_shapes or ()):
        shp = tuple(int(d) for d in shp)
        run = _sliding_window(model, tile_fn, tile_rng, out_mult, shp, cin, sw_overlap,
                              out_dtype if transfer_dtype else None)
        vols = torch.zeros((2, *shp, cin), device=dev)
        sw_ep, sw_plan = _trace(model, run, vols, tile_rng, out_dtype, None, f"k{i}")
        blobs[f"sw{i}.pt2"] = _save(sw_ep)
        sw_meta.append({"program": f"sw{i}.pt2", "case_spatial": list(shp),
                        "overlap": float(sw_overlap), "out_mult": out_mult,
                        "needs_rng": tile_rng, "draws": sw_plan})

    dtype = getattr(model, "members", [model])[0].dtype or torch.float32
    meta = {
        "format_version": _FORMAT_VERSION,
        "platforms": list(PLATFORMS),
        "traced_on": dev.type,
        "torch": torch.__version__,
        "dtype": str(dtype).replace("torch.", ""),
        "input_spatial_dims": list(spatial),
        "input_channels": cin,
        "batch": batch,  # null -> symbolic
        "needs_rng": needs_rng,
        "draws": plan,
        "mc_iter": int(mc_iter),
        "tta": bool(tta),
        "num_classes": int(model.num_classes),
        "cascaded": bool(model.cascaded),
        "probabilistic": bool(model.probabilistic),
        "num_members": int(getattr(model, "num_members", 1)),
        "output": "mean_std" if (needs_rng and mc_iter > 1) else "probs",
        "transfer_dtype": transfer_dtype,
        "sliding_window": sw_meta,
        "config": {k: v for k, v in model.config.items() if k != "init_params"},
    }
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
        for name, blob in blobs.items():
            z.writestr(name, blob)
        z.writestr("meta.json", json.dumps(meta, indent=1, default=str))
    os.replace(tmp, path)  # atomic, as utils.serialization
    return path


def _load_program(blob: bytes, device: torch.device):
    import torch.export.passes

    ep = torch.export.load(io.BytesIO(blob))
    return torch.export.passes.move_to_device_pass(ep, device).module()


class ExportedModel:
    """A loaded artifact: no model code needed.

    ``predict(x, rng=None)`` follows ``serve.InferenceSession.__call__``: fp32
    numpy ``probs`` or ``(mean, std)``. A stochastic program draws its
    inputs from ``rng`` (a generator on the device or an int seed) or, when
    it is omitted, from ``fold_in(generator(seed), n)`` for the call's number
    n, as the live session does.
    """

    def __init__(self, program, meta: dict, seed: int = 0,
                 sw_programs: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        self._prog = program
        self._sw = dict(sw_programs or {})  # case_spatial tuple -> (program, entry)
        self.meta = dict(meta)
        self.needs_rng = bool(meta["needs_rng"])
        self.num_classes = int(meta["num_classes"])
        self.mc_iter = int(meta["mc_iter"])
        # the corner of the M1 surface serve.run reads
        self.cascaded = bool(meta["cascaded"])
        self.probabilistic = bool(meta["probabilistic"])
        self.input_spatial_dims = tuple(meta["input_spatial_dims"])
        self.input_channels = int(meta["config"]["input_channels"])
        self.config = dict(meta["config"])
        self._rng = prng.generator(seed, self.device)
        self._calls = 0

    @classmethod
    def load(cls, path: str, seed: int = 0, device="cuda") -> "ExportedModel":
        """Load ``path`` onto ``device`` (raises without a card unless
        ``device="cpu"``); the port's ops are imported first, so the
        ``pmr::`` operators exist before ``torch.export.load``."""
        dev = resolve_device(device)
        from .ops import convolution, normalization  # noqa: F401  (registers pmr::)

        with zipfile.ZipFile(path, "r") as z:
            meta = json.loads(z.read("meta.json"))
            program = _load_program(z.read("program.pt2"), dev)
            sw = {tuple(e["case_spatial"]): (_load_program(z.read(e["program"]), dev), e)
                  for e in meta.get("sliding_window", [])}
        return cls(program, meta, seed=seed, sw_programs=sw, device=dev)

    def _draws(self, plan, rng, n: int):
        if rng is None:
            rng = prng.fold_in(self._rng, self._calls)
            self._calls += 1
        return prng.plan_draws(plan, prng.as_rng(rng, self.device), _draw_shapes(plan, n))

    def _tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(self.device, torch.float32).contiguous()

    def predict(self, x, rng=None):
        x = self._tensor(x)
        fixed = self.meta.get("batch")
        if fixed is not None and x.shape[0] != fixed:
            raise ValueError(
                f"artifact was exported with fixed batch {fixed}; got batch {x.shape[0]} "
                "(export with batch=None for a symbolic batch dimension)")
        args = (x,)
        if self.needs_rng:
            args += (self._draws(self.meta["draws"], rng, int(x.shape[0])),)
        with torch.no_grad():
            out = self._prog(*args)
        return tree_map(lambda t: t.float().cpu().numpy(), out)

    __call__ = predict

    @property
    def sw_geometries(self):
        """Case geometries with an exported sliding-window program."""
        return sorted(self._sw)

    @property
    def sw_entries(self):
        """The sliding-window metadata: ``{case_spatial: {"overlap": ...,
        "out_mult": ..., ...}}``."""
        return {shape: dict(entry) for shape, (_, entry) in self._sw.items()}

    def predict_cases(self, vols, rng=None):
        """Whole cases through the artifact's sliding-window programs.
        ``vols``: a list of (D, H, W, C) arrays sharing ONE geometry that was
        among ``sw_shapes`` at export. Returns ``[(probs, std | None), ...]``
        like the serve sessions."""
        block = self._tensor(np.stack([np.asarray(v, np.float32) for v in vols]))
        shape = tuple(block.shape[1:-1])
        if shape not in self._sw:
            raise ValueError(
                f"no sliding-window program for case geometry {shape}; artifact was "
                f"exported with sw_shapes={self.sw_geometries} (re-export with this "
                "geometry, or serve from a live checkpoint)")
        program, entry = self._sw[shape]
        args = (block,)
        if entry["needs_rng"]:
            args += (self._draws(entry["draws"], rng, len(vols)),)
        with torch.no_grad():
            out = program(*args).float().cpu().numpy()
        nc = self.num_classes
        if entry["out_mult"] == 2:
            return [(out[i][..., :nc], out[i][..., nc:]) for i in range(len(vols))]
        return [(out[i], None) for i in range(len(vols))]


def validate_artifact(model, path: str, *, mc_iter: int = 1, tta: bool = False,
                      transfer_dtype: Optional[str] = None, batch: int = 2,
                      seed: int = 0) -> float:
    """Reload ``path`` on the model's device and compare one random-input
    forward against the live ``model`` on the same draws (a generator of
    ``seed``), and each sliding-window program against a freshly built live
    one: the deployment gate. Returns the max abs deviation; raises if it
    exceeds 1e-4 (5e-3 under a transfer dtype)."""
    dev = torch.device(model.device)
    loaded = ExportedModel.load(path, device=dev)
    cin = int(loaded.meta["input_channels"])
    spatial = tuple(loaded.meta["input_spatial_dims"])
    b = int(loaded.meta.get("batch") or batch)
    x = np.random.default_rng(seed).normal(size=(b, *spatial, cin)).astype(np.float32)

    head, needs_rng = _detect_head(model, mc_iter, tta)
    xt = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        ref = head(xt, prng.generator(seed, dev)) if needs_rng else head(xt)
    got = loaded.predict(x, rng=prng.generator(seed, dev)) if needs_rng else loaded.predict(x)
    ref_leaves = ref if isinstance(ref, tuple) else (ref,)
    got_leaves = got if isinstance(got, tuple) else (got,)
    err = max(float(np.max(np.abs(r.float().cpu().numpy() - g)))
              for r, g in zip(ref_leaves, got_leaves))
    tol = 5e-3 if transfer_dtype else 1e-4

    if loaded.sw_entries:
        tile_fn, tile_rng, out_mult = _tile_head(model, mc_iter, tta)
    for shape, entry in loaded.sw_entries.items():
        live = _sliding_window(model, tile_fn, tile_rng, out_mult, shape, cin,
                               entry["overlap"],
                               getattr(torch, transfer_dtype) if transfer_dtype else None)
        vols = np.random.default_rng(seed + 1).normal(size=(2, *shape, cin)).astype(np.float32)
        vt = torch.from_numpy(vols).to(dev)
        with torch.no_grad():
            ref_sw = (live(vt, prng.generator(seed, dev)) if tile_rng else live(vt))
        ref_sw = ref_sw.float().cpu().numpy()
        got_sw = loaded.predict_cases(list(vols), rng=prng.generator(seed, dev)) \
            if tile_rng else loaded.predict_cases(list(vols))
        for i, (gp, gu) in enumerate(got_sw):
            stacked = np.concatenate([gp, gu], -1) if gu is not None else gp
            err = max(err, float(np.max(np.abs(ref_sw[i] - stacked))))

    if err > tol:
        raise AssertionError(
            f"exported artifact deviates from the live model: max |diff| {err:.3e} > "
            f"{tol} - do not deploy {path}")
    return err


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        "prostatemr_3d_cad_cspca_tpu_torch.export",
        description="Freeze a trained checkpoint (or a comma-separated fold ensemble) "
                    "into one self-contained inference artifact (torch.export program "
                    "+ weights).")
    p.add_argument("--MODEL", type=str, required=True,
                   help="checkpoint path; comma-separate K fold checkpoints to bake "
                        "the whole ensemble into the artifact")
    p.add_argument("--OUT", type=str, required=True, help="output artifact path (.zip)")
    p.add_argument("--MC_ITER", type=int, default=1)
    p.add_argument("--TTA", type=int, default=0)
    p.add_argument("--DEVICE", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device the program is traced and validated on (the artifact "
                        "runs on either)")
    p.add_argument("--DTYPE", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute type of the frozen program")
    p.add_argument("--BATCH", type=int, default=0,
                   help="fixed batch size; 0 = symbolic (any batch)")
    p.add_argument("--TRANSFER_DTYPE", type=str, default="float32",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--SW_SHAPE", type=int, nargs=3, action="append", default=None,
                   metavar=("D", "H", "W"),
                   help="oversized case geometry to bake a sliding-window program for "
                        "(repeatable); the artifact then serves whole-gland volumes of "
                        "these shapes too")
    p.add_argument("--SW_OVERLAP", type=float, default=0.5)
    p.add_argument("--VALIDATE", type=int, default=1,
                   help="after exporting, reload the artifact and check a random-input "
                        "forward against the live model (deployment safety; 0 skips)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    from .load import load_model_spec

    dev = resolve_device(args.DEVICE)
    overrides = {} if args.DTYPE == "float32" else {"dtype": getattr(torch, args.DTYPE)}
    model = load_model_spec(args.MODEL, allow_artifact=False, device=dev, **overrides)
    tdt = None if args.TRANSFER_DTYPE == "float32" else args.TRANSFER_DTYPE
    t0 = time.perf_counter()
    out = export_model(model, args.OUT, mc_iter=args.MC_ITER, tta=bool(args.TTA),
                       batch=args.BATCH or None, transfer_dtype=tdt,
                       sw_shapes=args.SW_SHAPE, sw_overlap=args.SW_OVERLAP)
    seconds = time.perf_counter() - t0
    print(f"Exported {args.MODEL} -> {out} ({os.path.getsize(out) / 1e6:.1f} MB in "
          f"{seconds:.1f} s, traced on {dev.type}, dtype={args.DTYPE}, "
          f"batch={'symbolic' if not args.BATCH else args.BATCH}, mc_iter={args.MC_ITER}, "
          f"tta={bool(args.TTA)}, sw_shapes={args.SW_SHAPE or []})", flush=True)
    if args.VALIDATE:
        try:
            err = validate_artifact(model, out, mc_iter=args.MC_ITER, tta=bool(args.TTA),
                                    transfer_dtype=tdt)
        except BaseException:
            # never leave a failed artifact at the deployable path: a pipeline
            # that globs for the file instead of checking the exit code must
            # not ship it
            try:
                os.remove(out)
            except OSError:
                pass
            raise
        print(f"Validated: artifact == live model on a random batch (max |diff| "
              f"{err:.2e}, incl. {len(args.SW_SHAPE or [])} sliding-window program(s))",
              flush=True)
    return out


if __name__ == "__main__":
    main()
