"""The kernel calls of M1's inference head and train step, from the
configuration's shapes alone, with each call's operations and bytes.

A call is ``Call(kind, flops, bytes, dtype)``; kinds are the program's
kernels: ``K1`` conv, ``K2`` transposed conv, ``K3`` norm statistics,
``K4`` norm apply, ``K6`` conv weight gradient, ``K7`` norm backward. A
train step adds, for every conv, the data gradient the backward launches
(a K1's by a K2 of the output gradient, a K2's by a K1; none for a conv on
the input volume, which needs no gradient) and one K6 per input part.

Operations are 2 x the multiply-adds of the convolution at the call's
shapes, counted once whatever a kernel splits them into: a SAME conv's
output voxels x taps x Cin x Cout (every tap counted, at the border too);
a transposed conv's input voxels x taps x Cin x Cout. A norm's: 4 an
element for the statistics (two multiply-adds), 2 for the apply, 8 for
the backward. Bytes are each input read once and each output written
once, in the call's dtype (biases, statistics and norm parameters fp32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence


@dataclass(frozen=True)
class Call:
    kind: str
    flops: float
    bytes: float
    dtype: str


def _same_out(n, k, s):
    return -(-n // s)


class _Counter:
    def __init__(self, batch: int, dtype: str, train: bool, dilated: bool = False):
        self.b, self.dt, self.train, self.dilated = int(batch), dtype, bool(train), dilated
        self.e = 2 if dtype == "bfloat16" else 4
        self.calls: List[Call] = []

    def conv(self, parts_c: Sequence[int], spatial, k, s, cout, needs_dgrad=True):
        """K1 over channel parts of one spatial size; returns the output's
        spatial size. Its backward: K2 (data gradient), K6 a part."""
        b, e = self.b, self.e
        taps, cin = math.prod(k), sum(parts_c)
        out = tuple(_same_out(n, kk, ss) for n, kk, ss in zip(spatial, k, s))
        nin, nout = math.prod(spatial), math.prod(out)
        macs = b * nout * taps * cin * cout
        w = taps * cin * cout
        self.calls.append(Call("K1", 2.0 * macs, e * (b * nin * cin + w + b * nout * cout)
                               + 4 * cout, self.dt))
        if self.train:
            if needs_dgrad:
                # K2 of the output gradient: its grid's voxels x s, cropped to the input
                self.calls.append(Call("K2", 2.0 * macs, e * (b * nout * cout + w
                                                              + b * nin * cin), self.dt))
            for c in parts_c:
                self.calls.append(Call("K6", 2.0 * b * nout * taps * c * cout,
                                       e * (b * nin * c + b * nout * cout) + 4 * taps * c * cout,
                                       self.dt))
        return out

    def convt(self, cin, spatial, k, s, cout):
        """K2: output n * s. Its backward: K1 (data gradient) and K6."""
        b, e = self.b, self.e
        taps = math.prod(k)
        out = tuple(n * ss for n, ss in zip(spatial, s))
        nin, nout = math.prod(spatial), math.prod(out)
        macs = b * (nout if self.dilated else nin) * taps * cin * cout
        w = taps * cin * cout
        self.calls.append(Call("K2", 2.0 * macs, e * (b * nin * cin + w + b * nout * cout)
                               + 4 * cout, self.dt))
        if self.train:
            self.calls.append(Call("K1", 2.0 * macs, e * (b * nout * cout + w + b * nin * cin),
                                   self.dt))
            self.calls.append(Call("K6", 2.0 * macs, e * (b * nout * cout + b * nin * cin)
                                   + 4 * w, self.dt))
        return out

    def norm(self, c, spatial):
        """K3 + K4 (+ K7 in training)."""
        b, e = self.b, self.e
        n = b * math.prod(spatial) * c
        self.calls.append(Call("K3", 4.0 * n, e * n + 4 * 2 * b * c, self.dt))
        self.calls.append(Call("K4", 2.0 * n, 2 * e * n + 4 * (2 * b * c + 2 * c), self.dt))
        if self.train:  # reads x and the output gradient, writes the input gradient
            self.calls.append(Call("K7", 8.0 * n, 3 * e * n + 4 * (2 * b * c + 4 * c), self.dt))

    def se(self, parts_c, spatial, f, k, s):
        q = f // 4
        cin = sum(parts_c)
        out = self.conv(parts_c, spatial, k, s, q)
        self.norm(q, out)
        self.conv([q], out, (3, 3, 3), (1, 1, 1), q)
        self.norm(q, out)
        self.conv([q], out, (1, 1, 1), (1, 1, 1), f)
        self.norm(f, out)
        if cin != f:
            self.conv(parts_c, spatial, k, s, f)
            self.norm(f, out)
        return out

    def att(self, c, spatial, gc, gspatial, sub):
        theta = self.conv([c], spatial, sub, sub, c)
        self.conv([gc], gspatial, (1, 1, 1), (1, 1, 1), c)
        self.conv([c], theta, (1, 1, 1), (1, 1, 1), 1)
        self.conv([c], spatial, (1, 1, 1), (1, 1, 1), c)
        self.norm(c, spatial)

    def trunk(self, cfg, cin, logits=True):
        f, k, s = cfg["filters"], cfg["kernel_sizes"], cfg["strides"]
        sp = [tuple(cfg["input_spatial_dims"])]
        sp0 = self.conv([cin], sp[0], k[0], s[0], f[0], needs_dgrad=False)
        self.norm(f[0], sp0)
        sp = [sp0]
        for i in range(1, 5):
            sp.append(self.se([f[i - 1]], sp[-1], f[i], k[i], s[i]))
        for i in range(4):
            self.att(f[i], sp[i], f[4], sp[4], cfg["att_sub_samp"][i])
        h = sp[4]
        for i in (3, 2, 1, 0):
            h = self.convt(f[i + 1], h, k[i + 1], s[i + 1], f[i])
            h = self.se([f[i], f[i]], h, f[i], k[i], (1, 1, 1))
        if logits:
            self.conv([f[0]], h, (1, 1, 1), (1, 1, 1), cfg["num_classes"])
        return sp

    def ladder(self, cfg, sp):
        f, k, s = cfg["filters"], cfg["kernel_sizes"], cfg["strides"]
        dims = tuple(cfg["prob_latent_dims"])
        fr, kr, sr = f[::-1], k[::-1], s[::-1]
        spr = sp[::-1]
        h = spr[0]
        for i in range(4):
            if dims[i]:
                self.conv([fr[i]], h, (1, 1, 1), (1, 1, 1), 2 * dims[i])
            h = self.convt(dims[i] + fr[i], h, kr[i], sr[i], fr[i + 1])
            h = self.se([fr[i + 1], fr[i + 1], fr[i + 1]], h, fr[i + 1], kr[i + 1], (1, 1, 1))
        self.conv([f[0]], h, (1, 1, 1), (1, 1, 1), cfg["num_classes"])


def detect_calls(cfg: dict, batch: int, dtype: str, dilated: bool = False) -> List[Call]:
    """The calls of one inference-head forward over ``batch`` volumes: the
    trunk (and for the probabilistic net the prior's trunk, its sampling
    ladder and the final logits). ``dilated`` counts a transposed conv as
    JAX counts its lhs-dilated input, whole (the zeros too): for checking
    against counts made that way, never for a share."""
    c = _Counter(batch, dtype, train=False, dilated=dilated)
    if not cfg.get("probabilistic"):
        c.trunk(cfg, cfg["input_channels"])
        return c.calls
    sp = c.trunk(cfg, cfg["input_channels"] - (cfg["num_classes"] - 1))
    c.ladder(cfg, sp)
    return c.calls


def train_calls(cfg: dict, batch: int, dtype: str) -> List[Call]:
    """The calls of one train step of the single-stage net: forward and
    backward."""
    if cfg.get("probabilistic") or cfg.get("deep_supervision"):
        raise ValueError("counted: the single-stage net without deep supervision")
    c = _Counter(batch, dtype, train=True)
    c.trunk(cfg, cfg["input_channels"])
    return c.calls


CONV_KINDS = ("K1", "K2", "K6")


def model_flops(calls: Sequence[Call]) -> float:
    """The model's FLOPs in ``calls``: every convolution's, forward and
    backward (norms and elementwise work are not counted)."""
    return sum(c.flops for c in calls if c.kind in CONV_KINDS)


def launches(calls: Sequence[Call]) -> dict:
    out = {}
    for c in calls:
        out[c.kind] = out.get(c.kind, 0) + 1
    return out
