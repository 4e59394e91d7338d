"""M1 with nested dense skips (UNet++, reference ``networks.py:592-623``),
alone or under the hierarchical probabilistic ladder (``networks.py:
633-734``), in plain PyTorch and fp32: the reference's full M1 beside
``m1.py``, whose conventions, layouts, names and operations it takes
(``Net``, ``conv``, ``dropout``).

Dense skips: each decoder stage i's transposed conv output ``deconv_i``
also starts an up-chain of transposed convs, ``convtd<i>_up1`` ...
``convtd<i>_up<i>``, one level up each (``convtd<i>_up<u>`` to level
``i - u``, with that level's kernel and stride). Stage i's stitch is, in
this channel order, ``(deconv_i, deconv_<i+1>_up1, deconv_<i+2>_up2, ...,
deconv_3_up<3-i>, att_conv_i)``: 2, 3, 4 and 5 parts at stages 3, 2, 1, 0.
The ladder stitches its upsampled features onto those, so its SE blocks
take 3, 4, 5 and 6 parts. The up-chains draw nothing: the draws come in
``m1.py``'s site order.

Without ``dense_skip`` every function here is ``m1.py``'s.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from . import m1
from .m1 import Net, conv, dropout


def _stitch_parts(i: int) -> int:
    """The parts of decoder stage ``i``'s dense stitch: its deconv, the
    ``3 - i`` up-chains from the deeper stages, its gated skip."""
    return 5 - i


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """Every parameter of the single-stage M1 for the model dict ``cfg``,
    dense skips or not: name -> shape (the program's names)."""
    d = m1.param_shapes(dict(cfg, dense_skip=False))
    if not cfg.get("dense_skip"):
        return d
    f, k, r = cfg["filters"], cfg["kernel_sizes"], cfg["se_reduction"]
    fr, kr, rr = f[::-1], k[::-1], r[::-1]
    prefixes = ("prior", "posterior") if cfg.get("probabilistic") else ("core",)
    for p in prefixes:
        # the stitch blocks take their dense widths (their names keep their place)
        for i in (2, 1, 0):
            m1._se(d, f"{p}.sersd{i}", _stitch_parts(i) * f[i], f[i], k[i], r[i])
        if cfg.get("probabilistic"):
            for i in range(4):
                m1._se(d, f"{p}.sersp_{i}", (1 + _stitch_parts(3 - i)) * fr[i + 1],
                       fr[i + 1], kr[i + 1], rr[i + 1])
        for i in (3, 2, 1):
            for u in range(1, i + 1):
                m1._convt(d, f"{p}.convtd{i}_up{u}", k[i + 1 - u], f[i + 1 - u], f[i - u])
    return d


class DenseNet(Net):
    """``Net`` whose decoder adds the dense skips' up-chains to its stitches."""

    def trunk(self, x, draws, logits=True):
        if not self.cfg.get("dense_skip"):
            return super().trunk(x, draws, logits)
        s, r = self.cfg["strides"], self.rate
        x0 = self.n("norme0", self.c("conve0", x, s[0]), True)
        enc = [x0]
        for i in range(1, 5):
            enc.append(dropout(self.se(f"serse{i}", [enc[-1]], s[i]), r, draws))
        convm = enc[4]
        atts = [self.att(i, enc[i], convm) for i in range(4)]
        chains, stitch, h = {}, {}, convm
        for i in (3, 2, 1, 0):
            chain = [self.convt(f"convtd{i}", h, s[i + 1])]
            for u in range(1, i + 1):  # convtd<i>_up<u>: level i - u's kernel and stride
                chain.append(self.convt(f"convtd{i}_up{u}", chain[-1], s[i + 1 - u]))
            chains[i] = chain
            stitch[i] = (chain[0], *(chains[j][j - i] for j in range(i + 1, 4)), atts[i])
            h = dropout(self.se(f"sersd{i}", list(stitch[i]), (1, 1, 1)),
                        r / 2 if i == 0 else r, draws)
        out = dict(convm=convm, stitch=stitch, uconv0=h)
        if logits:
            out["logits"] = self.c("logits", h)
        return out


def detect(params, cfg: dict, x: torch.Tensor, draws) -> torch.Tensor:
    """The inference head: softmax probabilities (N, C, D, H, W) of NCDHW
    ``x`` (for the probabilistic net, the prior's sampling pass over the
    dense trunk's stitches)."""
    if not cfg.get("probabilistic"):
        net = DenseNet(params, "core", cfg)
        return torch.softmax(net.trunk(x, draws)["logits"], dim=1)
    n_lbl = cfg["num_classes"] - 1
    prior = DenseNet(params, "prior", cfg)
    trunk = prior.trunk(x[:, :x.shape[1] - n_lbl], draws, logits=False)
    h = prior.ladder_sample(trunk, draws)
    logits = conv(h, params["final_decoder.logits.kernel"], params["final_decoder.logits.bias"],
                  (1, 1, 1))
    return torch.softmax(logits, dim=1)


def mc_mean_std(params, cfg, x: torch.Tensor, draws, samples: int):
    """Monte-Carlo mean and population std over ``samples`` draws, stacked
    sample-major on the batch axis and run as one forward: NCDHW each."""
    b = x.shape[0]
    probs = detect(params, cfg, x.repeat(samples, 1, 1, 1, 1), draws)
    probs = probs.reshape(samples, b, *probs.shape[1:])
    return probs.mean(0), probs.std(0, correction=0)

