"""M1, the attention U-Net of the reference (DIAGNijmegen prostateMR_3D-CAD-csPCa,
``networks.py`` and ``network_blocks.py``), in plain PyTorch and fp32.

Tensors are NCDHW here; weights keep the program's layouts and names so the
benchmark hands both sides one dict: a conv kernel is DHWIO ``(kd, kh, kw,
Cin, Cout)``, a transposed conv kernel ``(kd, kh, kw, Cout, Cin)`` (TF's
Conv3DTranspose), names are the '.'-joined module paths (``core.serse1.
conv1.kernel``; ``prior.``/``posterior.``/``final_decoder.`` for the
probabilistic net).

Conventions of the published model kept here: XLA/TF SAME padding (the
window may start on the first voxel: pad_lo = total // 2); instance norm
over the spatial axes with epsilon 1e-3 and a learned affine; LeakyReLU
0.1; the SE-ResNet bottleneck multiplies the gated features by the
shortcut; dropout ``where(u < keep, x / keep, 0)`` with ``u`` uniform in
[0, 1) of the activation's (N, D, H, W, C) shape; the last decoder dropout
at half the rate; per-voxel Gaussian latents with log-sigma clipped to
[-0.1, 0.1], ``z = mu + sigma * eps``.

Draws come from a ``draws.Stream`` in the order the
forward reaches the sites: ``drope1``-``drope4``, ``dropd3``-``dropd0``,
then per ladder level the latent's ``eps`` (where the level samples one)
and ``dropp_i``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F

EPSILON = 1e-3
SLOPE = 0.1
LOGSIG_CLIP = 0.1


# ------------------------------------------------------------- parameters
def _se(d, p, cin, f, k, red):
    q = f // 4
    d[f"{p}.conv1.kernel"], d[f"{p}.conv1.bias"] = (*k, cin, q), (q,)
    d[f"{p}.norm1.scale"], d[f"{p}.norm1.bias"] = (q,), (q,)
    d[f"{p}.conv2.kernel"], d[f"{p}.conv2.bias"] = (3, 3, 3, q, q), (q,)
    d[f"{p}.norm2.scale"], d[f"{p}.norm2.bias"] = (q,), (q,)
    d[f"{p}.conv3.kernel"], d[f"{p}.conv3.bias"] = (1, 1, 1, q, f), (f,)
    d[f"{p}.norm3.scale"], d[f"{p}.norm3.bias"] = (f,), (f,)
    if cin != f:
        d[f"{p}.conv4.kernel"], d[f"{p}.conv4.bias"] = (*k, cin, f), (f,)
        d[f"{p}.norm4.scale"], d[f"{p}.norm4.bias"] = (f,), (f,)
    d[f"{p}.se_conv6.kernel"], d[f"{p}.se_conv6.bias"] = (1, 1, 1, f, f // red), (f // red,)
    d[f"{p}.se_conv7.kernel"], d[f"{p}.se_conv7.bias"] = (1, 1, 1, f // red, f), (f,)


def _conv(d, p, k, cin, cout):
    d[f"{p}.kernel"], d[f"{p}.bias"] = (*k, cin, cout), (cout,)


def _convt(d, p, k, cin, cout):
    d[f"{p}.kernel"], d[f"{p}.bias"] = (*k, cout, cin), (cout,)


def _core_shapes(d, p, cin, cfg, deep_supervision, probabilistic):
    f, k, s, r = cfg["filters"], cfg["kernel_sizes"], cfg["strides"], cfg["se_reduction"]
    nc, sub = cfg["num_classes"], cfg["att_sub_samp"]
    _conv(d, f"{p}.conve0", k[0], cin, f[0])
    d[f"{p}.norme0.scale"], d[f"{p}.norme0.bias"] = (f[0],), (f[0],)
    for i in range(1, 5):
        _se(d, f"{p}.serse{i}", f[i - 1], f[i], k[i], r[i])
    for i in range(4):
        _conv(d, f"{p}.att{i}.theta", sub[i], f[i], f[i])
        _conv(d, f"{p}.att{i}.phi", (1, 1, 1), f[4], f[i])
        _conv(d, f"{p}.att{i}.psi", (1, 1, 1), f[i], 1)
        _conv(d, f"{p}.att{i}.out", (1, 1, 1), f[i], f[i])
        d[f"{p}.att{i}.norm_out.scale"], d[f"{p}.att{i}.norm_out.bias"] = (f[i],), (f[i],)
    for i in (3, 2, 1, 0):
        _convt(d, f"{p}.convtd{i}", k[i + 1], f[i + 1], f[i])
        _se(d, f"{p}.sersd{i}", 2 * f[i], f[i], k[i], r[i])
    _conv(d, f"{p}.logits", (1, 1, 1), f[0], nc)
    if deep_supervision:
        for i in (1, 2, 3):
            _conv(d, f"{p}.dsy{i}_logits", (1, 1, 1), f[i], nc)
    if probabilistic:
        dims = tuple(cfg["prob_latent_dims"])
        fr, kr, rr = f[::-1], k[::-1], r[::-1]
        for i in range(4):
            if dims[i]:
                _conv(d, f"{p}.mu_logsig_{i}", (1, 1, 1), fr[i], 2 * dims[i])
            _convt(d, f"{p}.dec_hi_{i}", kr[i], dims[i] + fr[i], fr[i + 1])
            _se(d, f"{p}.sersp_{i}", 3 * fr[i + 1], fr[i + 1], kr[i + 1], rr[i + 1])


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """Every parameter of M1 for the model dict ``cfg`` (single-stage, no
    dense skips): name -> shape."""
    if cfg.get("dense_skip") or cfg.get("cascaded"):
        raise ValueError("the reference covers single-stage M1 without dense skips")
    d: "OrderedDict[str, tuple]" = OrderedDict()
    ds = bool(cfg.get("deep_supervision"))
    if not cfg.get("probabilistic"):
        _core_shapes(d, "core", cfg["input_channels"], cfg, ds, False)
        return d
    n_lbl = cfg["num_classes"] - 1
    _core_shapes(d, "prior", cfg["input_channels"] - n_lbl, cfg, ds, True)
    _core_shapes(d, "posterior", cfg["input_channels"], cfg, False, True)
    _conv(d, "final_decoder.logits", (1, 1, 1), cfg["filters"][0], cfg["num_classes"])
    return d


# ------------------------------------------------------------- operations
def same_pads(n: int, k: int, s: int):
    """TF/XLA SAME along one axis: (out, pad_lo, pad_hi)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return out, total // 2, total - total // 2


def conv(x, w, b, stride):
    """SAME conv of NCDHW ``x`` with a DHWIO kernel."""
    pads = []
    for axis in (2, 1, 0):
        _, lo, hi = same_pads(x.shape[2 + axis], w.shape[axis], stride[axis])
        pads += [lo, hi]
    return F.conv3d(F.pad(x, pads), w.permute(4, 3, 0, 1, 2), b, tuple(stride))


def _transpose_offset(k: int, s: int) -> int:
    # where TF's SAME transposed output starts inside the full (padding 0) one
    pad_a = k - 1 if s > k - 1 else -((k + s - 2) // -2)
    return k - 1 - pad_a


def conv_transpose(x, w, b, stride):
    """SAME transposed conv (output n * s) of NCDHW ``x`` with a
    (kd, kh, kw, Cout, Cin) kernel."""
    y = F.conv_transpose3d(x, w.permute(4, 3, 0, 1, 2), None, tuple(stride))
    for axis in range(3):
        k, s = w.shape[axis], stride[axis]
        c, size = _transpose_offset(k, s), x.shape[2 + axis] * s
        short = c + size - y.shape[2 + axis]
        if short > 0:
            pad = [0, 0] * (2 - axis) + [0, short] + [0, 0] * axis
            y = F.pad(y, pad)
        y = y.narrow(2 + axis, c, size)
    return y + b.view(1, -1, 1, 1, 1)


def norm(x, scale, bias, lrelu=False):
    """Instance norm over the spatial axes (two passes), learned affine."""
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPSILON) * scale.view(1, -1, 1, 1, 1) \
        + bias.view(1, -1, 1, 1, 1)
    return F.leaky_relu(y, SLOPE) if lrelu else y


def upsample(x, factors):
    for i, f in enumerate(factors):
        if f != 1:
            x = torch.repeat_interleave(x, int(f), dim=2 + i)
    return x


def ndhwc(shape_ncdhw):
    n, c, d, h, w = shape_ncdhw
    return (n, d, h, w, c)


def dropout(x, rate, draws):
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = draws.uniform(ndhwc(x.shape)).permute(0, 4, 1, 2, 3)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Net:
    """One M1 core's weights (``prefix``) and config; the functions of the
    published network over them."""

    def __init__(self, params: Dict[str, torch.Tensor], prefix: str, cfg: dict):
        self.p = {k[len(prefix) + 1:]: v for k, v in params.items()
                  if k.startswith(prefix + ".")}
        self.cfg = cfg
        self.rate = float(cfg["dropout_rate"]) if cfg["dropout_mode"] == "monte-carlo" else 0.0

    def c(self, name, x, stride=(1, 1, 1)):
        return conv(x, self.p[f"{name}.kernel"], self.p[f"{name}.bias"], stride)

    def n(self, name, x, lrelu=False):
        return norm(x, self.p[f"{name}.scale"], self.p[f"{name}.bias"], lrelu)

    def se(self, name, parts, stride):
        x = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
        h = self.n(f"{name}.norm1", self.c(f"{name}.conv1", x, stride), True)
        h = self.n(f"{name}.norm2", self.c(f"{name}.conv2", h), True)
        x_ = self.n(f"{name}.norm3", self.c(f"{name}.conv3", h))
        if f"{name}.conv4.kernel" in self.p:
            residual = self.n(f"{name}.norm4", self.c(f"{name}.conv4", x, stride))
        else:
            residual = x
        s = x_.mean(dim=(2, 3, 4))
        w6, b6 = self.p[f"{name}.se_conv6.kernel"], self.p[f"{name}.se_conv6.bias"]
        w7, b7 = self.p[f"{name}.se_conv7.kernel"], self.p[f"{name}.se_conv7.bias"]
        s = F.leaky_relu(s @ w6.reshape(w6.shape[3], w6.shape[4]) + b6, SLOPE)
        s = torch.sigmoid(s @ w7.reshape(w7.shape[3], w7.shape[4]) + b7)
        return F.leaky_relu(x_ * s[:, :, None, None, None] * residual, SLOPE)

    def att(self, i, x, g):
        sub = tuple(self.cfg["att_sub_samp"][i])
        theta_x = self.c(f"att{i}.theta", x, sub)
        phi_g = self.c(f"att{i}.phi", g)
        up1 = [theta_x.shape[2 + a] // phi_g.shape[2 + a] for a in range(3)]
        f = F.leaky_relu(theta_x + upsample(phi_g, up1), SLOPE)
        psi = torch.sigmoid(self.c(f"att{i}.psi", f))
        up2 = [x.shape[2 + a] // psi.shape[2 + a] for a in range(3)]
        psi = upsample(psi, up2)
        return self.n(f"att{i}.norm_out", self.c(f"att{i}.out", psi * x))

    def convt(self, name, x, stride):
        return conv_transpose(x, self.p[f"{name}.kernel"], self.p[f"{name}.bias"], stride)

    def trunk(self, x, draws, logits=True):
        """Stem, encoder, attention, decoder (and logits): a dict of the
        decoder's stitch parts and outputs."""
        s, r = self.cfg["strides"], self.rate
        x0 = self.n("norme0", self.c("conve0", x, s[0]), True)
        enc = [x0]
        for i in range(1, 5):
            enc.append(dropout(self.se(f"serse{i}", [enc[-1]], s[i]), r, draws))
        convm = enc[4]
        atts = [self.att(i, enc[i], convm) for i in range(4)]
        stitch, h = {}, convm
        for i in (3, 2, 1, 0):
            deconv = self.convt(f"convtd{i}", h, s[i + 1])
            stitch[i] = (deconv, atts[i])
            h = dropout(self.se(f"sersd{i}", list(stitch[i]), (1, 1, 1)),
                        r / 2 if i == 0 else r, draws)
        out = dict(convm=convm, stitch=stitch, uconv0=h)
        if logits:
            out["logits"] = self.c("logits", h)
        return out

    def ladder_sample(self, trunk, draws):
        """The prior's sampling pass: per level a latent drawn from the
        per-voxel Gaussian, upsampled with the features and stitched onto the
        trunk's stitch parts."""
        dims = tuple(self.cfg["prob_latent_dims"])
        sr = self.cfg["strides"][::-1]
        h = trunk["convm"]
        for i in range(4):
            if dims[i]:
                ml = self.c(f"mu_logsig_{i}", h)
                mu, logsig = ml[:, :dims[i]], ml[:, dims[i]:]
                eps = draws.normal(ndhwc(mu.shape)).permute(0, 4, 1, 2, 3).to(mu.dtype)
                z = mu + torch.exp(torch.clamp(logsig, -LOGSIG_CLIP, LOGSIG_CLIP)) * eps
                dec_in = torch.cat([z, h], 1)
            else:
                dec_in = h
            up = self.convt(f"dec_hi_{i}", dec_in, sr[i])
            h = dropout(self.se(f"sersp_{i}", [up, *trunk["stitch"][3 - i]], (1, 1, 1)),
                        self.rate, draws)
        return h


def detect(params, cfg: dict, x: torch.Tensor, draws) -> torch.Tensor:
    """The inference head: softmax probabilities (N, C, D, H, W) of NCDHW
    ``x`` (for the probabilistic net, the prior's sampling pass)."""
    if not cfg.get("probabilistic"):
        net = Net(params, "core", cfg)
        return torch.softmax(net.trunk(x, draws)["logits"], dim=1)
    n_lbl = cfg["num_classes"] - 1
    prior = Net(params, "prior", cfg)
    trunk = prior.trunk(x[:, :x.shape[1] - n_lbl], draws, logits=False)
    h = prior.ladder_sample(trunk, draws)
    logits = conv(h, params["final_decoder.logits.kernel"], params["final_decoder.logits.bias"],
                  (1, 1, 1))
    return torch.softmax(logits, dim=1)


def train_probs(params, cfg: dict, x: torch.Tensor, draws) -> torch.Tensor:
    """The training forward of a single-stage net without deep supervision:
    y_softmax (N, C, D, H, W), the dropout sites drawn as in training."""
    if cfg.get("probabilistic") or cfg.get("deep_supervision"):
        raise ValueError("the reference trains the single-stage net without deep supervision")
    net = Net(params, "core", cfg)
    return torch.softmax(net.trunk(x, draws)["logits"], dim=1)


def mc_mean_std(params, cfg, x: torch.Tensor, draws, samples: int):
    """Monte-Carlo mean and population std over ``samples`` draws, stacked
    sample-major on the batch axis and run as one forward: NCDHW each."""
    b = x.shape[0]
    probs = detect(params, cfg, x.repeat(samples, 1, 1, 1, 1), draws)
    probs = probs.reshape(samples, b, *probs.shape[1:])
    return probs.mean(0), probs.std(0, correction=0)


def to_ndhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 4, 1)


def to_ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)

