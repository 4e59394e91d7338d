"""M1Core, the (hierarchical probabilistic) attention U-Net backbone: port of
the JAX package's ``models/m1_core.py``. Submodule names follow the flax
tree, so the state dict keys are the JAX keypaths with '.' for '/'. As in
flax, a submodule exists only where the configuration calls it: the dense
skips' transposed convs with ``dense_skip``, the ``dsy*`` heads with
``deep_supervision``, the ladder with ``probabilistic`` (``mu_logsig_<i>``
only at levels whose latent dim is not 0).

Topology (reference networks.py:411-416): a (1,3,3) stem, four SE encoder
blocks, four attention gates on the bottleneck, four transposed-conv decoder
stages whose stitch inputs stay part lists (no concat is materialized;
dense skips add the upsampled outputs of the deeper stages to each stitch,
up to five parts at stage 0), and 1x1x1 logits. ``trunk`` runs that;
``ladder`` runs the latent hierarchy on a trunk's outputs (the wrapper runs
a trunk once and a ladder per latent configuration); ``assemble_outputs``
adds the deep-supervision heads. Dropout sites (``drope1``-``drope4``,
``dropd3``-``dropd0``, the last at half the rate; ``dropp_0``-``dropp_3``
in the ladder) take the ``rng`` of the call: a generator or a mapping (see
``prng``); each follows an SE block, which is handed it and applies it
(``blocks.SEResNetBottleNeck``'s ``drop``: on a card, in K8's pass). ``sharded`` (``ops.normalization.ShardedStats``, halo-sharded
execution) gives every norm and SE squeeze whole-volume statistics and
re-zeroes the vacuum after each transposed conv and around the ladder's
``dec_hi`` (JAX ``m1_core.py:231-259``, ``:322-323``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.convolution import Conv3d, ConvConfig, ConvTranspose3d, store_act
from ..ops.distributions import DiagGaussian
from ..ops.normalization import InstanceNorm, ShardedStats, revacuum
from ..ops.resample import upsample_nearest
from ..prng import Draws, is_mask_map
from ..utils.profiling import annotate
from .blocks import ConfigurableDropout, GridAttentionBlock3D, SEResNetBottleNeck


def _latent(level: int, distrib: DiagGaussian, rng) -> torch.Tensor:
    """A sampled latent: the mapping's ``z_<level>``, or a reparameterized
    draw from the generator (or ``prng.Draws``)."""
    if is_mask_map(rng):
        key = f"z_{level}"
        if key not in rng:
            raise KeyError(f"no latent {key!r} in the mapping")
        z = torch.as_tensor(rng[key], device=distrib.loc.device).to(distrib.loc.dtype)
        if tuple(z.shape) != tuple(distrib.loc.shape):
            raise ValueError(f"latent {key!r} has shape {tuple(z.shape)}, the "
                             f"distribution {tuple(distrib.loc.shape)}")
        if torch.is_grad_enabled() and (distrib.loc.requires_grad
                                        or distrib.scale.requires_grad):
            # reparameterize around the replayed value: z itself, with the
            # gradient of loc + scale * eps for the noise eps it implies
            loc, scale = distrib.loc, distrib.scale
            eps = (z - loc.detach()) / scale.detach()
            z = z + (loc - loc.detach()) + (scale - scale.detach()) * eps
        return z
    if not isinstance(rng, (torch.Generator, Draws)):
        raise ValueError("sampling a latent needs rng: a torch.Generator, prng.Draws "
                         "or a mapping of latents")
    return distrib.sample(rng, site=f"z_{level}")


class M1Core(nn.Module):
    """Backbone network (see module docstring)."""

    def __init__(
        self,
        input_channels: int,
        num_classes: int = 2,
        dropout_mode: str = "standard",
        dropout_rate: float = 0.50,
        filters=(32, 64, 128, 256, 512),
        strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
        kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
        se_reduction=(8, 8, 8, 8, 8),
        att_sub_samp=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
        conv_cfg: ConvConfig = ConvConfig(),
        dense_skip: bool = False,
        deep_supervision: bool = False,
        probabilistic: bool = False,
        prob_latent_dims: Sequence[int] = (1, 1, 1, 1),
    ):
        super().__init__()
        for name, val, n in (("filters", filters, 5), ("se_reduction", se_reduction, 5),
                             ("strides", strides, 5), ("kernel_sizes", kernel_sizes, 5),
                             ("att_sub_samp", att_sub_samp, 4)):
            if len(val) != n or (name in ("strides", "kernel_sizes", "att_sub_samp")
                                 and any(len(v) != 3 for v in val)):
                raise ValueError(f"{name} needs {n} entries (3D ones for "
                                 f"strides/kernels/sub-sampling), got {val!r}")
        self.num_classes = num_classes
        self.conv_cfg = cfg = conv_cfg
        self.strides = tuple(tuple(v) for v in strides)
        self.dense_skip, self.deep_supervision = bool(dense_skip), bool(deep_supervision)
        self.probabilistic = bool(probabilistic)
        f, s, k, r = filters, strides, kernel_sizes, se_reduction

        def sers(cin, filt, kern, stride, red):
            return SEResNetBottleNeck(cin, filt, kern, stride, red, cfg)

        def drop(rate, site):
            return ConfigurableDropout(rate, dropout_mode, site)

        def convt(cin, feats, kern, stride):
            return ConvTranspose3d(cin, feats, kern, stride, cfg)

        # Stem (networks.py:472-474).
        self.conve0 = Conv3d(input_channels, f[0], k[0], s[0], cfg)
        self.norme0 = InstanceNorm(f[0])
        # Encoder (networks.py:476-487).
        self.serse1 = sers(f[0], f[1], k[1], s[1], r[1])
        self.serse2 = sers(f[1], f[2], k[2], s[2], r[2])
        self.serse3 = sers(f[2], f[3], k[3], s[3], r[3])
        self.serse4 = sers(f[3], f[4], k[4], s[4], r[4])
        self.drope1, self.drope2, self.drope3, self.drope4 = (
            drop(dropout_rate, f"drope{i}") for i in range(1, 5))
        # Attention gates on the bottleneck (networks.py:490-493).
        self.att0 = GridAttentionBlock3D(f[0], f[4], f[0], att_sub_samp[0], cfg)
        self.att1 = GridAttentionBlock3D(f[1], f[4], f[1], att_sub_samp[1], cfg)
        self.att2 = GridAttentionBlock3D(f[2], f[4], f[2], att_sub_samp[2], cfg)
        self.att3 = GridAttentionBlock3D(f[3], f[4], f[3], att_sub_samp[3], cfg)
        # Decoder stages 3..0 (networks.py:496-523): a transposed conv, then
        # an SE block over the stage's stitch (deconv, [dense skips], gated
        # skip); dense skips add 1, 2, 3 upsampled parts at stages 2, 1, 0.
        nd = 1 if dense_skip else 0
        self.convtd3 = convt(f[4], f[3], k[4], s[4])
        self.sersd3 = sers(2 * f[3], f[3], k[3], (1, 1, 1), r[3])
        self.dropd3 = drop(dropout_rate, "dropd3")
        self.convtd2 = convt(f[3], f[2], k[3], s[3])
        self.sersd2 = sers((2 + nd) * f[2], f[2], k[2], (1, 1, 1), r[2])
        self.dropd2 = drop(dropout_rate, "dropd2")
        self.convtd1 = convt(f[2], f[1], k[2], s[2])
        self.sersd1 = sers((2 + 2 * nd) * f[1], f[1], k[1], (1, 1, 1), r[1])
        self.dropd1 = drop(dropout_rate, "dropd1")
        self.convtd0 = convt(f[1], f[0], k[1], s[1])
        self.sersd0 = sers((2 + 3 * nd) * f[0], f[0], k[0], (1, 1, 1), r[0])
        self.dropd0 = drop(dropout_rate / 2, "dropd0")
        if dense_skip:  # networks.py:497-499, 506-507, 514
            self.convtd3_up1 = convt(f[3], f[2], k[3], s[3])
            self.convtd3_up2 = convt(f[2], f[1], k[2], s[2])
            self.convtd3_up3 = convt(f[1], f[0], k[1], s[1])
            self.convtd2_up1 = convt(f[2], f[1], k[2], s[2])
            self.convtd2_up2 = convt(f[1], f[0], k[1], s[1])
            self.convtd1_up1 = convt(f[1], f[0], k[1], s[1])
        # Logits + deep supervision heads (networks.py:526-531).
        self.logits = Conv3d(f[0], num_classes, (1, 1, 1), (1, 1, 1), cfg)
        if deep_supervision:
            self.dsy1_logits = Conv3d(f[1], num_classes, (1, 1, 1), (1, 1, 1), cfg)
            self.dsy2_logits = Conv3d(f[2], num_classes, (1, 1, 1), (1, 1, 1), cfg)
            self.dsy3_logits = Conv3d(f[3], num_classes, (1, 1, 1), (1, 1, 1), cfg)
        # Probabilistic ladder (networks.py:534-565), levels at res 3, 2, 1, 0.
        if probabilistic:
            dims = tuple(prob_latent_dims)
            if len(dims) != 4:
                raise ValueError(f"prob_latent_dims needs 4 entries (res 3,2,1,0), "
                                 f"got {dims!r}")
            self.prob_latent_dims = dims
            fr, sr, kr, rr = f[::-1], s[::-1], k[::-1], r[::-1]
            # the channels of each level's trunk stitch (uconv3_ .. uconv0_)
            stitch = (2 * f[3], (2 + nd) * f[2], (2 + 2 * nd) * f[1], (2 + 3 * nd) * f[0])
            for i in range(4):
                setattr(self, f"mu_logsig_{i}", Conv3d(
                    fr[i], 2 * dims[i], (1, 1, 1), (1, 1, 1), cfg) if dims[i] else None)
                setattr(self, f"dec_hi_{i}", convt(dims[i] + fr[i], fr[i + 1], kr[i], sr[i]))
                setattr(self, f"sersp_{i}", sers(fr[i + 1] + stitch[i], fr[i + 1],
                                                  kr[i + 1], (1, 1, 1), rr[i + 1]))
                setattr(self, f"dropp_{i}", drop(dropout_rate, f"dropp_{i}"))

    def trunk(self, inputs: torch.Tensor, train: bool = False,
              rng=None, sharded: Optional[ShardedStats] = None) -> Dict[str, Any]:
        """Stem -> encoder -> attention -> decoder -> logits (networks.py:
        568-630). The ``uconv*_`` entries are part tuples standing for the
        reference's stitch concats."""
        sa = lambda t: store_act(self.conv_cfg, t)  # noqa: E731
        rv = lambda t: sa(revacuum(t, sharded))  # noqa: E731

        def up(conv, t):  # one transposed conv of a dense skip's up-chain
            with annotate("m1.dense"):
                return rv(conv(t))

        if self.conv_cfg.dtype is not None:
            inputs = inputs.to(self.conv_cfg.dtype)
        d: Dict[str, Any] = {}
        x = sa(self.conve0(inputs))
        x = sa(self.norme0(x, lrelu=True, sharded=sharded))
        d["x"] = x

        conv1 = self.serse1(x, sharded, (self.drope1, train, rng))
        conv2 = self.serse2(conv1, sharded, (self.drope2, train, rng))
        conv3 = self.serse3(conv2, sharded, (self.drope3, train, rng))
        convm = self.serse4(conv3, sharded, (self.drope4, train, rng))
        d.update(conv1=conv1, conv2=conv2, conv3=conv3, convm=convm)

        att_conv0, att_0 = self.att0(x, convm, sharded)
        att_conv1, att_1 = self.att1(conv1, convm, sharded)
        att_conv2, att_2 = self.att2(conv2, convm, sharded)
        att_conv3, att_3 = self.att3(conv3, convm, sharded)
        att_conv0, att_conv1, att_conv2, att_conv3 = (
            sa(att_conv0), sa(att_conv1), sa(att_conv2), sa(att_conv3))
        d.update(att_conv0=att_conv0, att_conv1=att_conv1,
                 att_conv2=att_conv2, att_conv3=att_conv3,
                 att_map0=att_0, att_map1=att_1, att_map2=att_2, att_map3=att_3)

        # Stage 3 (networks.py:590-597).
        deconv3 = rv(self.convtd3(convm))
        if self.dense_skip:
            deconv3_up1 = up(self.convtd3_up1, deconv3)
            deconv3_up2 = up(self.convtd3_up2, deconv3_up1)
            deconv3_up3 = up(self.convtd3_up3, deconv3_up2)
        uconv3_ = (deconv3, att_conv3)
        uconv3 = self.sersd3(uconv3_, sharded, (self.dropd3, train, rng))
        # Stage 2 (networks.py:599-607).
        deconv2 = rv(self.convtd2(uconv3))
        if self.dense_skip:
            deconv2_up1 = up(self.convtd2_up1, deconv2)
            deconv2_up2 = up(self.convtd2_up2, deconv2_up1)
            uconv2_ = (deconv2, deconv3_up1, att_conv2)
        else:
            uconv2_ = (deconv2, att_conv2)
        uconv2 = self.sersd2(uconv2_, sharded, (self.dropd2, train, rng))
        # Stage 1 (networks.py:609-616).
        deconv1 = rv(self.convtd1(uconv2))
        if self.dense_skip:
            deconv1_up1 = up(self.convtd1_up1, deconv1)
            uconv1_ = (deconv1, deconv2_up1, deconv3_up2, att_conv1)
        else:
            uconv1_ = (deconv1, att_conv1)
        uconv1 = self.sersd1(uconv1_, sharded, (self.dropd1, train, rng))
        # Stage 0 (networks.py:618-624).
        deconv0 = rv(self.convtd0(uconv1))
        if self.dense_skip:
            uconv0_ = (deconv0, deconv1_up1, deconv2_up2, deconv3_up3, att_conv0)
        else:
            uconv0_ = (deconv0, att_conv0)
        uconv0 = self.sersd0(uconv0_, sharded, (self.dropd0, train, rng))
        d.update(uconv3_=uconv3_, uconv3=uconv3, uconv2_=uconv2_, uconv2=uconv2,
                 uconv1_=uconv1_, uconv1=uconv1, uconv0_=uconv0_, uconv0=uconv0)

        y__ = self.logits(uconv0)
        if self.num_classes > 1:
            y_ = torch.argmax(y__, dim=-1)
        else:
            y_ = (y__[..., 0] >= 0.5).to(torch.int32)
        d.update(logits=y__, y_=y_)
        return d

    def ladder(self, trunk: Dict[str, Any], prob_mean: bool = False,
               prob_z_q: Optional[Sequence[Optional[torch.Tensor]]] = None,
               train: bool = False, rng=None,
               sharded: Optional[ShardedStats] = None) -> Dict[str, Any]:
        """Hierarchical latent decoder (networks.py:633-734). Per level (res
        3, 2, 1, 0): a per-voxel diagonal Gaussian from the running features
        (1x1x1 ``mu_logsig``); the conditioning latent is the injected
        ``prob_z_q[i]``, else the mean with ``prob_mean``, else a sample
        (see :func:`_latent`); [latent, features] is upsampled by a
        transposed conv and stitched onto the trunk's stitch parts (a part
        list: up to six parts); an SE block and dropout follow."""
        if not self.probabilistic:
            raise ValueError("ladder needs probabilistic=True")
        dims = self.prob_latent_dims
        skip_srcs = (trunk["uconv3_"], trunk["uconv2_"], trunk["uconv1_"], trunk["uconv0_"])
        distributions, used, ds_ops = [], [], []
        features = trunk["convm"]
        for i in range(4):
            if dims[i]:
                mu_logsigma = getattr(self, f"mu_logsig_{i}")(features)
                distrib = DiagGaussian.from_mu_logsigma(mu_logsigma[..., :dims[i]],
                                                        mu_logsigma[..., dims[i]:])
                if prob_z_q is not None and prob_z_q[i] is not None:
                    z = prob_z_q[i]
                elif prob_mean:
                    z = distrib.mean
                else:
                    z = _latent(i, distrib, rng)
                distributions.append(distrib)
                used.append(z)
                dec_in = torch.cat([z.to(features.dtype), features], dim=-1)
            else:
                distributions.append(None)
                used.append(None)
                dec_in = features
            # latents carry bias and noise into the vacuum: zero it around dec_hi
            upsampled = revacuum(getattr(self, f"dec_hi_{i}")(revacuum(dec_in, sharded)),
                                 sharded)
            stitched = (upsampled, *skip_srcs[i])
            features = getattr(self, f"sersp_{i}")(
                stitched, sharded, (getattr(self, f"dropp_{i}"), train, rng))
            if i < 3:
                ds_ops.append(features)
        return dict(prob_distributions=tuple(distributions),
                    prob_used_latents=tuple(used),
                    prob_decoder_features=features, ds_ops=tuple(ds_ops))

    def _deep_supervision(self, srcs):
        """Upsample three decoder stages to full resolution, then 1x1x1
        logits (networks.py:737-747); ``srcs`` = (stage 1, 2, 3 features)."""
        s = [np.array(t) for t in self.strides]
        y_1 = self.dsy1_logits(upsample_nearest(srcs[0], tuple(s[1])))
        y_2 = self.dsy2_logits(upsample_nearest(srcs[1], tuple(s[1] * s[2])))
        y_3 = self.dsy3_logits(upsample_nearest(srcs[2], tuple(s[1] * s[2] * s[3])))
        return y_1, y_2, y_3

    def assemble_outputs(self, trunk: Dict[str, Any],
                         ladder_out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Final output dict (networks.py:749-759): with deep supervision
        the softmax and sigmoid of the logits and the three heads,
        concatenated in that order on the channel axis."""
        y__ = trunk["logits"]
        out: Dict[str, Any] = {}
        if self.deep_supervision:
            if self.probabilistic:
                ds = ladder_out["ds_ops"]
                srcs = (ds[-1], ds[-2], ds[-3])  # networks.py:745-747
            else:
                srcs = (trunk["uconv1"], trunk["uconv2"], trunk["uconv3"])
            heads = (y__, *self._deep_supervision(srcs))
            out["y_softmax"] = torch.cat([torch.softmax(t, dim=-1) for t in heads], dim=-1)
            out["y_sigmoid"] = torch.cat([torch.sigmoid(t) for t in heads], dim=-1)
        else:
            out["y_softmax"] = torch.softmax(y__, dim=-1)
            out["y_sigmoid"] = torch.sigmoid(y__)
        out["logits"] = y__
        out["y_"] = trunk["y_"]
        if ladder_out is not None:
            for key in ("prob_distributions", "prob_used_latents", "prob_decoder_features"):
                out[key] = ladder_out[key]
        return out

    def forward(self, inputs: torch.Tensor, train: bool = False, rng=None,
                prob_mean: bool = False, prob_z_q=None,
                sharded: Optional[ShardedStats] = None) -> Dict[str, Any]:
        """One reference pass (networks.py:568-759): trunk, ladder, heads."""
        trunk = self.trunk(inputs, train, rng, sharded)
        ladder_out = (self.ladder(trunk, prob_mean, prob_z_q, train, rng, sharded)
                      if self.probabilistic else None)
        return self.assemble_outputs(trunk, ladder_out)
