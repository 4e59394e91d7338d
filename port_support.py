"""What the port's card tooling and its tests share; it imports no JAX.

``chip_smoke.py`` (the card's checks), ``tools/`` (per-kernel device times)
and the port's tests import this module; it imports the port's package and
nothing of theirs. torch and the package are imported inside the functions
that need them.

* Model configurations at the benchmark's widths: ``CFG1`` (the CLI's
  default M1) and its variants ``CFG2``, ``PROB``, ``PROB_DENSE``,
  ``CASCADE`` and ``TRAIN_CFG``.
* The kernel calls of a path, traced on the meta device: ``recording``,
  ``trace_model_calls``, ``trace_path_calls``, ``launch_counts``; the SE
  blocks' output shapes (K8's operands), ``trace_se_shapes``.
* fp64 references: ``_conv_fp64`` (K1's function) and ``BranchReplay`` (an
  fp32 step's branch decisions, replayed in its fp64 evaluation).
* One kernel call's operands on the card at a traced signature
  (``_conv_case``, ``_pair_case``, ``_convt_case``, ``_wgrad_case``,
  ``_in_case``), the one torch call that computes the same function
  (``_conv_library``, ``_convt_library``, ``_wgrad_library``) and a K1/K2
  call's plan (``_conv_plan``).
* Measurement: ``time_ms`` (device time of a call, CUDA-graph replayed),
  ``device_time`` (a profile's device busy time and time by kernel) and
  ``ptxas_variants`` (nvcc's -Xptxas -v report, one entry a compiled
  kernel).
"""

from __future__ import annotations

import collections
import contextlib
import re

# cfg1: the CLI's default architecture (bench cfg1), 93.2 GFLOP per volume
CFG1 = dict(
    input_spatial_dims=(20, 160, 160), input_channels=3, num_classes=2,
    filters=(16, 32, 64, 128, 256),
    strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
    kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    se_reduction=(8, 8, 8, 8, 8),
    att_sub_samp=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
    dropout_rate=0.0, dropout_mode="standard")
# bench cfg2 (benchmarks/bench_core.py:87-96, 300-341); the reference README's
# model (JAX models/m1.py:7-12) at cfg1 width, its 4th input channel the label
# that test-mode images carry as zeros; the cascade (noisy-or fusion)
CFG2 = dict(CFG1, dense_skip=True, deep_supervision=True)
PROB = dict(CFG1, input_channels=4, probabilistic=True, prob_latent_dims=(3, 2, 1, 0),
            deep_supervision=True, dropout_mode="monte-carlo", dropout_rate=0.5)
CASCADE = dict(CFG1, cascaded="noisy-or")
PROB_DENSE = dict(PROB, dense_skip=True)  # a 6-part stitch; served in bench cell prob_dense_mc4_b8
# the CLI's training defaults (prostatemr_3d_cad_cspca_tpu/cli.py:54-102):
# monte-carlo dropout 0.5, L2 1e-5, focal alpha (1, 1) gamma 2, Keras amsgrad
# at 1e-3 on CALR (2, 1, 1e-3) over 250 epochs, batch 2, fp32
TRAIN_CFG = dict(CFG1, dropout_mode="monte-carlo", dropout_rate=0.5,
                 kernel_regularizer=1e-5, bias_regularizer=1e-5)
# a cfg1 forward's launches by dtype: 50 K1 calls, of which the SE blocks'
# first and projection convs run as one K1 pair launch where the shapes let
# them (ops/convolution.py pair_fuses: five blocks in bf16, three in fp32)
LAUNCHES_PER_FORWARD = {
    "bfloat16": {"conv3d": 40, "conv3d_pair": 5, "conv3d_transpose": 4, "in_stats": 37,
                 "in_apply": 37},
    "float32": {"conv3d": 44, "conv3d_pair": 3, "conv3d_transpose": 4, "in_stats": 37,
                "in_apply": 37}}
FORWARD_KERNELS = tuple(LAUNCHES_PER_FORWARD["bfloat16"])
BACKWARD_KERNELS = ("conv3d_wgrad", "in_backward")


def _dn(dtype):
    return str(dtype).replace("torch.", "")


# ------------------------------------------------- path shapes (meta trace)
@contextlib.contextmanager
def recording(calls):
    """Append (kernel, shape signature, dtype name) to ``calls`` for every
    call of a kernel wrapper (K1-K4, K6, K7) while the context is open,
    device-agnostic: on the meta device it traces a path, on the card it
    records the shapes that path really gave its kernels."""
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution, normalization

    originals = {}

    class Recorder:
        """The wrapper in the module's place; its launch count is the
        wrapped function's, which the kernel's launch raises."""

        def __init__(self, name, orig, sig):
            self.name, self.orig, self.sig = name, orig, sig

        @property
        def launches(self):
            return self.orig.launches

        @launches.setter
        def launches(self, n):
            self.orig.launches = n

        def __call__(self, *a, **kw):
            first = (a or tuple(kw.values()))[0]
            first = first[0] if isinstance(first, (list, tuple)) else first
            calls.append((self.name, self.sig(*a, **kw), _dn(first.dtype)))
            return self.orig(*a, **kw)

    def record(mod, name, sig):
        originals[(mod, name)] = getattr(mod, name)
        setattr(mod, name, Recorder(name, originals[(mod, name)], sig))

    record(convolution, "conv3d", lambda parts, kernel, bias=None,
           strides=(1, 1, 1): (tuple(tuple(p.shape) for p in parts),
                               tuple(kernel.shape), tuple(strides)))
    # a K1 pair as the one launch it is: the kernels side by side ([kernel4 |
    # kernel1]) and the first output's columns
    record(convolution, "conv3d_pair", lambda parts, kernel1, bias1, kernel4, bias4,
           strides=(1, 1, 1): (tuple(tuple(p.shape) for p in parts),
                               (*kernel1.shape[:4], kernel1.shape[4] + kernel4.shape[4]),
                               tuple(strides), int(kernel4.shape[4])))
    record(convolution, "conv3d_transpose", lambda x, kernel, bias=None,
           strides=(1, 1, 1): (tuple(x.shape), tuple(kernel.shape), tuple(strides)))
    record(normalization, "in_stats", lambda x: (tuple(x.shape),))
    record(normalization, "in_apply", lambda x, stats, scale, bias, lrelu=False,
           epsilon=1e-3: (tuple(x.shape), bool(lrelu)))
    record(convolution, "conv3d_wgrad", lambda a, b, kernel_size, strides=(1, 1, 1): (
        tuple(a.shape), tuple(b.shape), tuple(kernel_size), tuple(strides)))
    record(normalization, "in_backward", lambda x, g, stats, scale, bias, lrelu=False,
           epsilon=1e-3: (tuple(x.shape), bool(lrelu)))
    try:
        yield calls
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)


def trace_model_calls(cfg, batch, dtype=None, head="detect"):
    """Every kernel call of one forward of the model ``cfg`` at ``batch`` in
    ``dtype`` (default bf16) through ``head`` ("detect": what serving runs,
    "forward", or "train": the train step's forward in training mode, the
    focal loss + L2 and the backward), found by running it on the meta
    device with recording wrappers (a CPU generator draws the meta tensors
    of dropout and latents)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    calls = []
    with recording(calls):
        model = M1(**cfg, summary=False, init_params=False, device="meta",
                   dtype=dtype or torch.bfloat16)
        x = torch.zeros((batch, *cfg["input_spatial_dims"], cfg["input_channels"]),
                        device="meta")
        gen = torch.Generator().manual_seed(0)
        if head == "train":  # the train step's forward and backward
            from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import l2_penalty
            from prostatemr_3d_cad_cspca_tpu_torch.train.trainer import make_loss

            out = model.net(x, train=True, rng=gen)
            y = torch.zeros(out["y_softmax"].shape, device="meta")
            (make_loss()(y, out["y_softmax"]) + l2_penalty(model.net, 1e-5, 1e-5)).backward()
        else:
            kw = {"train": False} if head == "forward" else {}
            with torch.no_grad():
                getattr(model.net, head)((x, x) if cfg.get("cascaded") else x, rng=gen, **kw)
    return collections.Counter((name, sig) for name, sig, _ in calls)


def trace_path_calls(batch, dtype=None):
    """Every kernel call of one cfg1 forward at ``batch`` in ``dtype``
    (default bf16); raises unless they are LAUNCHES_PER_FORWARD's."""
    import torch

    calls = trace_model_calls(CFG1, batch, dtype, head="forward")
    counts = collections.Counter()
    for (name, _), n in calls.items():
        counts[name] += n
    want = LAUNCHES_PER_FORWARD[_dn(dtype or torch.bfloat16)]
    if dict(counts) != want:
        raise AssertionError(f"cfg1 forward calls {dict(counts)}, expected {want}")
    return calls


def trace_se_shapes(cfg, batch):
    """The output shapes (B, D, H, W, C) of the SE blocks of one serving
    forward (``detect``) of ``cfg`` at ``batch``, with MC dropout at 0.5,
    counted (a meta forward): the tensors K8 runs over."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.blocks import SEResNetBottleNeck
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    shapes = collections.Counter()
    model = M1(**dict(cfg, dropout_mode="monte-carlo", dropout_rate=0.5), summary=False,
               init_params=False, device="meta", dtype=torch.bfloat16)
    hooks = [m.register_forward_hook(lambda _m, _i, out: shapes.update([tuple(out.shape)]))
             for m in model.net.modules() if isinstance(m, SEResNetBottleNeck)]
    x = torch.zeros((batch, *cfg["input_spatial_dims"], cfg["input_channels"]), device="meta")
    try:
        with torch.no_grad():
            model.net.detect((x, x) if cfg.get("cascaded") else x,
                             rng=torch.Generator().manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def launch_counts(calls, forwards=1):
    """Launches per kernel of ``forwards`` forwards of a traced model."""
    out = {k: 0 for k in (*FORWARD_KERNELS, "gemm_loop", *BACKWARD_KERNELS)}
    for (name, _), n in calls.items():
        out[name] += n * forwards
    return out


# ------------------------------------------------------- fp64 references
def _conv_fp64(parts, kernel, bias, strides):
    """K1's function in fp64, the exact product's stand-in: the parts'
    concat padded as XLA SAME pads, one fp64 matmul (cuBLAS) a tap over the
    strided window, summed, + bias; NDHWC."""
    import torch
    import torch.nn.functional as F
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import same_pads

    x = torch.cat(parts, dim=-1).double()
    ks, st = tuple(kernel.shape[:3]), tuple(strides)
    pads, out = [0, 0], []
    for axis in (2, 1, 0):  # F.pad lists the last axis first: C, W, H, D
        o, lo, hi = same_pads(int(x.shape[1 + axis]), ks[axis], st[axis])
        pads += [lo, hi]
        out.insert(0, o)
    x = F.pad(x, pads)
    w = kernel.double()
    y = torch.zeros((x.shape[0], *out, kernel.shape[4]), dtype=torch.float64, device=x.device)
    for a in range(ks[0]):
        for b in range(ks[1]):
            for c in range(ks[2]):
                win = x[:, a:a + (out[0] - 1) * st[0] + 1:st[0],
                        b:b + (out[1] - 1) * st[1] + 1:st[1],
                        c:c + (out[2] - 1) * st[2] + 1:st[2]]
                y += win @ w[a, b, c]
    return y + bias.double()


class BranchReplay:
    """The branch decisions of one fp32 step, replayed in its fp64
    evaluation.

    Where a value lies within rounding of a kink (a point where the slope
    jumps), the fp32 step and an fp64 evaluation that decides for itself
    can take different sides: an LReLU input near 0 takes slope 1 in one
    and 0.1 in the other, a 10x difference in that element's gradient that
    is no error of either step. ``record()`` notes, in call order, the side
    every element took at each kink of the forward: the LReLU sites
    (``models.blocks.leaky_relu01``: the SE tail and the attention gates),
    the instance norm's fused LReLU (``ops.normalization.
    _pre_activation_sign`` of the input and statistics the norm saves: on
    the card, the sign K4 and K7 compute from the same tensors) and the
    focal loss's clip (``losses._clip``). ``replay()`` makes the next step
    take those sides in the same order, a norm's backward finding its
    forward's side by its saved input, and raises if a recorded side is
    left over. With ``values``, ``record()`` also keeps each element's
    distance to its kink and its tensor's largest |value|, which
    ``flipped`` reads."""

    def __init__(self, values=False):
        self.sides = {"lrelu": [], "in_sign": [], "clip": []}
        self.near = {k: [] for k in self.sides} if values else None

    @staticmethod
    def _sites():
        from prostatemr_3d_cad_cspca_tpu_torch import losses
        from prostatemr_3d_cad_cspca_tpu_torch.models import blocks
        from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization

        return {"lrelu": (blocks, "leaky_relu01"),
                "in_forward": (normalization._InstanceNormFn, "forward"),
                "in_backward": (normalization._InstanceNormFn, "backward"),
                "in_sign": (normalization, "_pre_activation_sign"), "clip": (losses, "_clip")}

    @contextlib.contextmanager
    def _patched(self, fns):
        sites = self._sites()
        raw = {k: vars(sites[k][0])[sites[k][1]] for k in fns}
        for k, fn in fns.items():
            new = fn(getattr(*sites[k]))
            setattr(*sites[k], staticmethod(new) if isinstance(raw[k], staticmethod) else new)
        try:
            yield self
        finally:
            for k, orig in raw.items():
                setattr(*sites[k], orig)

    def record(self):
        import torch

        from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization

        sides, near, sign = self.sides, self.near, self._sites()["in_sign"]

        def keep(kind, dist, x):
            if near is not None:
                near[kind].append((dist.double().cpu(), float(x.detach().abs().max())))

        def lrelu(orig):
            def fn(x):
                sides["lrelu"].append(~(x > 0).detach().cpu())
                keep("lrelu", x.detach().abs(), x)
                return orig(x)
            return fn

        def in_forward(orig):
            def fn(ctx, x, scale, bias, lrelu, epsilon):
                y = orig(ctx, x, scale, bias, lrelu, epsilon)
                if lrelu:  # the sign K4 took, from the tensors the norm saved
                    sides["in_sign"].append(getattr(*sign)(*ctx.to_save, epsilon).cpu())
                    if near is not None:
                        pre = normalization._pre_activation(*ctx.to_save, epsilon)
                        keep("in_sign", pre.abs(), pre)
                return y
            return fn

        def clip(orig):
            def fn(x, lo, hi):
                x_ = x.detach().cpu()
                sides["clip"].append((x_ < lo, x_ > hi, x_ == lo, x_ == hi))
                keep("clip", torch.minimum((x_ - lo).abs(), (x_ - hi).abs()), x_)
                return orig(x, lo, hi)
            return fn

        return self._patched({"lrelu": lrelu, "in_forward": in_forward, "clip": clip})

    def flipped(self, other):
        """The elements whose side at a kink differs between this recording
        (made with ``values``) and ``other``'s of the same forward: (kind
        of kink, the element's distance to it in this recording over its
        tensor's largest |value|) each."""
        import torch

        out = []
        for kind, sides in self.sides.items():
            if len(sides) != len(other.sides[kind]):
                raise AssertionError(f"{kind}: {len(sides)} kinks against "
                                     f"{len(other.sides[kind])}")
            for (a, b), (dist, scale) in zip(zip(sides, other.sides[kind]), self.near[kind]):
                diff = (torch.stack(a) != torch.stack(b)).any(0) if isinstance(a, tuple) \
                    else a != b
                out.extend((kind, float(d) / max(scale, 1e-30)) for d in dist[diff])
        return out

    @contextlib.contextmanager
    def replay(self):
        import torch

        cursor = {k: iter(v) for k, v in self.sides.items()}
        by_input = {}  # a fused LReLU's side by its norm's input, for the backward

        def take(name, like):
            got = next(cursor[name])
            got = tuple(t.to(like.device) for t in got) if isinstance(got, tuple) \
                else got.to(like.device)
            shape = (got[0] if isinstance(got, tuple) else got).shape
            if tuple(shape) != tuple(like.shape):
                raise AssertionError(f"replay {name}: recorded {tuple(shape)}, "
                                     f"got {tuple(like.shape)}")
            return got

        def lrelu(orig):
            return lambda x: torch.where(take("lrelu", x), 0.1 * x, x)

        def in_forward(orig):
            def fn(ctx, x, scale, bias, lrelu, epsilon):
                if lrelu:
                    by_input[x.data_ptr()] = take("in_sign", x)
                return orig(ctx, x, scale, bias, lrelu, epsilon)
            return fn

        def in_sign(orig):
            return lambda x, *args: by_input[x.data_ptr()]

        def clip(orig):
            def fn(x, lo, hi):  # jnp.clip's gradients: 0 outside, 1/2 on a tie
                below, above, tie_lo, tie_hi = take("clip", x)
                lo_t, hi_t = (torch.full_like(x, v) for v in (lo, hi))
                out = torch.where(tie_lo, 0.5 * (x + lo_t), x)
                out = torch.where(tie_hi, 0.5 * (x + hi_t), out)
                return torch.where(below, lo_t, torch.where(above, hi_t, out))
            return fn

        with self._patched({"lrelu": lrelu, "in_forward": in_forward, "in_sign": in_sign,
                            "clip": clip}):
            yield self
        left = {k: sum(1 for _ in it) for k, it in cursor.items()}
        if any(left.values()):
            raise AssertionError(f"recorded sides not replayed: {left}")

    def replay_rows(self, rows, flips):
        """The recorded sides, cut to the batch rows ``rows``, taken by a
        step on any device (a data-parallel rank's share of the recorded
        step). The card's K4 and K7 decide a fused LReLU's side themselves,
        so each norm with one runs K4 and K7 without it and the recorded
        slope between them (forward: on K4's output; backward: on the
        gradient K7 takes). ``flips`` (a Counter) gets, per kind of kink,
        the elements whose own side differs from the recorded one."""
        import torch

        cursor = {k: iter(v) for k, v in self.sides.items()}
        sign = self._sites()["in_sign"]

        def take(name, like):
            got = next(cursor[name])
            got = tuple(t[rows].to(like.device) for t in got) if isinstance(got, tuple) \
                else got[rows].to(like.device)
            shape = (got[0] if isinstance(got, tuple) else got).shape
            if tuple(shape) != tuple(like.shape):
                raise AssertionError(f"replay {name}: recorded {tuple(shape)}, "
                                     f"got {tuple(like.shape)}")
            return got

        def lrelu(orig):
            def fn(x):
                side = take("lrelu", x)
                flips["lrelu"] += int((side != ~(x > 0)).sum())
                return torch.where(side, 0.1 * x, x)
            return fn

        def in_forward(orig):
            def fn(ctx, x, scale, bias, lrelu, epsilon):
                ctx.side = None
                if not lrelu:
                    return orig(ctx, x, scale, bias, lrelu, epsilon)
                y = orig(ctx, x, scale, bias, False, epsilon)
                ctx.side = take("in_sign", x)
                own = getattr(*sign)(x, ctx.to_save[1], scale, bias, epsilon)
                flips["in_sign"] += int((ctx.side != own).sum())
                return torch.where(ctx.side, 0.1 * y, y)
            return fn

        def in_backward(orig):
            def fn(ctx, gy):
                if ctx.side is not None:
                    gy = torch.where(ctx.side, 0.1 * gy, gy)
                return orig(ctx, gy)
            return fn

        def clip(orig):
            def fn(x, lo, hi):  # the recorded sides of the clip, ties as jnp.clip's
                below, above, tie_lo, tie_hi = take("clip", x)
                flips["clip"] += int(((x < lo) != below).sum() + ((x > hi) != above).sum())
                lo_t, hi_t = (torch.full_like(x, v) for v in (lo, hi))
                out = torch.where(tie_lo, 0.5 * (x + lo_t), x)
                out = torch.where(tie_hi, 0.5 * (x + hi_t), out)
                return torch.where(below, lo_t, torch.where(above, hi_t, out))
            return fn

        return self._patched({"lrelu": lrelu, "in_forward": in_forward,
                              "in_backward": in_backward, "clip": clip})


# ---------------------------------------------- one kernel call on the card
def _conv_case(sig, dtype, gen):
    import torch

    part_shapes, kshape, strides = sig
    parts = [torch.randn(s, generator=gen, device="cuda").to(dtype) for s in part_shapes]
    fan_in = kshape[0] * kshape[1] * kshape[2] * kshape[3]
    kernel = (torch.randn(kshape, generator=gen, device="cuda") / fan_in ** 0.5).to(dtype)
    bias = torch.randn(kshape[4], generator=gen, device="cuda") * 0.1
    return parts, kernel, bias, strides


def _pair_case(sig, dtype, gen):
    """A K1 pair's operands: ``_conv_case`` of the whole kernel, split into
    conv1's (the last q columns) and conv4's (the first f) kernels and
    biases."""
    parts, kernel, bias, st = _conv_case(sig[:3], dtype, gen)
    f = sig[3]
    return (parts, kernel[..., f:].contiguous(), bias[f:].contiguous(),
            kernel[..., :f].contiguous(), bias[:f].contiguous(), st)


def _convt_case(sig, dtype, gen):
    import torch

    xshape, kshape, strides = sig
    x = torch.randn(xshape, generator=gen, device="cuda").to(dtype)
    fan_in = kshape[0] * kshape[1] * kshape[2] * kshape[4]
    kernel = (torch.randn(kshape, generator=gen, device="cuda") / fan_in ** 0.5).to(dtype)
    bias = torch.randn(kshape[3], generator=gen, device="cuda") * 0.1
    return x, kernel, bias, strides


def _in_case(shape, dtype, gen):
    import torch

    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias


def _wgrad_case(sig, dtype, gen):
    import torch

    ashape, bshape, ks, st = sig
    a = torch.randn(ashape, generator=gen, device="cuda").to(dtype)
    b = torch.randn(bshape, generator=gen, device="cuda").to(dtype)
    return a, b, tuple(ks), tuple(st)


def _wgrad_library(a, b, ks, st):
    """One cuDNN call computing K6's function (as an NCDHW weight gradient):
    A padded as XLA SAME pads, outside the timed call."""
    import torch
    import torch.nn.functional as F
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import same_pads

    pads = []
    for axis in (2, 1, 0):
        _, lo, hi = same_pads(a.shape[1 + axis], ks[axis], st[axis])
        pads += [lo, hi]
    ap = F.pad(a.permute(0, 4, 1, 2, 3), pads).contiguous(memory_format=torch.channels_last_3d)
    bt = b.permute(0, 4, 1, 2, 3)
    size = (b.shape[-1], a.shape[-1], *ks)
    return lambda: torch.nn.grad.conv3d_weight(ap, size, bt, stride=st)


def _conv_library(parts, kernel, strides):
    """One cuDNN call computing K1's function: the parts' concat and the XLA
    SAME asymmetric padding are prepared outside the timed call."""
    import torch
    import torch.nn.functional as F
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import same_pads

    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    pads = []
    for axis in (2, 1, 0):
        _, lo, hi = same_pads(x.shape[1 + axis], kernel.shape[axis], strides[axis])
        pads += [lo, hi]
    xp = F.pad(x.permute(0, 4, 1, 2, 3), pads).contiguous(
        memory_format=torch.channels_last_3d)
    w = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    return lambda: F.conv3d(xp, w, stride=strides)


def _convt_library(x, kernel, strides):
    """One cuDNN call computing K2's function: torch's full transposed conv,
    whose SAME window is a view."""
    import torch
    import torch.nn.functional as F

    xt = x.permute(0, 4, 1, 2, 3)
    w = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    return lambda: F.conv_transpose3d(xt, w, stride=strides)


def _conv_plan(name, sig, dtype):
    """The wgmma_plan of one K1/K2 call in ``dtype``."""
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    transposed = name == "conv3d_transpose"  # a pair's sig[1] is its whole kernel
    shapes = [tuple(sig[0])] if transposed else [tuple(s) for s in sig[0]]
    return cv.wgmma_plan(shapes, tuple(sig[1]), tuple(sig[2]), transposed, dtype=dtype)


# ---------------------------------------------------------- measurement
def time_ms(fn, reps, capture=True):
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, after one warm-up call and one
    warm-up replay. The capture takes each call's launches on the current
    stream and its ``torch.empty`` allocations; the host's work (numpy
    packing, ctypes, Python) stays outside the replay, so kernel, twin and
    library call are timed alike, on the device. ``capture=False`` is for a
    ``fn`` that already replays a graph: its calls are timed as they are."""
    import torch

    fn()
    torch.cuda.synchronize()
    if capture:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        run = graph.replay
    else:
        run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    run()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _is_range(evt):
    """A ``record_function`` range shown on the device's timeline (it spans
    its kernels and the gaps between them), not a kernel."""
    return bool(getattr(evt, "is_user_annotation", False)) or evt.name == "augment"


def device_time(prof):
    """(device busy us: the union of the device's intervals, device us by
    kernel name, device events) of a torch.profiler run."""
    import torch

    spans, by_name = [], collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.time_range.elapsed_us() > 0 \
                and not _is_range(evt):
            spans.append((evt.time_range.start, evt.time_range.end))
            ident = re.search(r"(\w+)[<(]", evt.name)
            by_name[ident.group(1) if ident else evt.name[:40]] += evt.time_range.elapsed_us()
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy, by_name, len(spans)


def ptxas_variants(log):
    """Each kernel variant in nvcc's ``-Xptxas -v`` report ``log``, in
    compile order: {"name": its mangled name, "registers", "smem_bytes"
    (static shared memory), "spill_bytes" (stores + loads)}; registers None
    where the report gives none."""
    out = []
    for line in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"name": m.group(1), "registers": None, "smem_bytes": 0,
                        "spill_bytes": 0})
            continue
        if not out:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[-1]["spill_bytes"] += int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used:
            out[-1]["registers"] = int(used.group(1))
            out[-1]["smem_bytes"] = int(used.group(2) or 0)
    return out
