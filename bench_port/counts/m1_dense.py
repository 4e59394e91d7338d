"""The kernel calls of M1's inference head with nested dense skips, by
``m1.py``'s rules (its ``_Counter``: each call's operations and bytes).

Dense skips add, at decoder stage i, the up-chain of ``i`` transposed
convs (K2) from ``deconv_i`` to level 0, and widen the stitches: stage i's
SE block takes ``5 - i`` parts (its first conv and projection conv are K1
calls over that part list), and the ladder's level over stage i's stitch
one part more (3 to 6 parts). Without ``dense_skip`` the calls are
``m1.py``'s.
"""

from __future__ import annotations

from typing import List

from .m1 import Call, _Counter


class _DenseCounter(_Counter):
    def trunk(self, cfg, cin, logits=True):
        if not cfg.get("dense_skip"):
            return super().trunk(cfg, cin, logits)
        f, k, s = cfg["filters"], cfg["kernel_sizes"], cfg["strides"]
        sp0 = self.conv([cin], tuple(cfg["input_spatial_dims"]), k[0], s[0], f[0],
                        needs_dgrad=False)
        self.norm(f[0], sp0)
        sp = [sp0]
        for i in range(1, 5):
            sp.append(self.se([f[i - 1]], sp[-1], f[i], k[i], s[i]))
        for i in range(4):
            self.att(f[i], sp[i], f[4], sp[4], cfg["att_sub_samp"][i])
        h = sp[4]
        for i in (3, 2, 1, 0):
            h = self.convt(f[i + 1], h, k[i + 1], s[i + 1], f[i])
            up = h
            for u in range(1, i + 1):  # convtd<i>_up<u>, to level i - u
                up = self.convt(f[i + 1 - u], up, k[i + 1 - u], s[i + 1 - u], f[i - u])
            h = self.se([f[i]] * (5 - i), h, f[i], k[i], (1, 1, 1))
        if logits:
            self.conv([f[0]], h, (1, 1, 1), (1, 1, 1), cfg["num_classes"])
        return sp

    def ladder(self, cfg, sp):
        if not cfg.get("dense_skip"):
            return super().ladder(cfg, sp)
        f, k, s = cfg["filters"], cfg["kernel_sizes"], cfg["strides"]
        dims = tuple(cfg["prob_latent_dims"])
        fr, kr, sr = f[::-1], k[::-1], s[::-1]
        h = sp[::-1][0]
        for i in range(4):
            if dims[i]:
                self.conv([fr[i]], h, (1, 1, 1), (1, 1, 1), 2 * dims[i])
            h = self.convt(dims[i] + fr[i], h, kr[i], sr[i], fr[i + 1])
            # the upsampled features, then trunk stage 3 - i's 2 + i parts
            h = self.se([fr[i + 1]] * (3 + i), h, fr[i + 1], kr[i + 1], (1, 1, 1))
        self.conv([f[0]], h, (1, 1, 1), (1, 1, 1), cfg["num_classes"])


def detect_calls(cfg: dict, batch: int, dtype: str, dilated: bool = False) -> List[Call]:
    """The calls of one inference-head forward over ``batch`` volumes, as
    ``m1.detect_calls`` counts them, dense skips or not."""
    c = _DenseCounter(batch, dtype, train=False, dilated=dilated)
    if not cfg.get("probabilistic"):
        c.trunk(cfg, cfg["input_channels"])
        return c.calls
    sp = c.trunk(cfg, cfg["input_channels"] - (cfg["num_classes"] - 1))
    c.ladder(cfg, sp)
    return c.calls
