"""M1Core, the attention U-Net backbone: port of the JAX package's
``models/m1_core.py`` for the single-stage path (``trunk`` and
``assemble_outputs``), dropout included. Submodule names follow the flax
tree, so the state dict keys are the JAX keypaths with '.' for '/'.

Topology (reference networks.py:411-416): a (1,3,3) stem, four SE encoder
blocks, four attention gates on the bottleneck, four transposed-conv decoder
stages whose stitch inputs stay part lists (no concat is materialized), and
1x1x1 logits. Eight dropout sites (``drope1``-``drope4``,
``dropd3``-``dropd0``, the last at half the rate) take the ``rng`` of
``trunk``: a generator, or a mapping from these site names to keep-masks.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..ops.convolution import Conv3d, ConvConfig, ConvTranspose3d, store_act
from ..ops.normalization import InstanceNorm
from .blocks import ConfigurableDropout, GridAttentionBlock3D, SEResNetBottleNeck


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
    ):
        super().__init__()
        if dense_skip or deep_supervision:
            raise NotImplementedError(
                "dense_skip / deep_supervision (cfg2) wait for the cfg2 slice")
        if probabilistic:
            raise NotImplementedError(
                "the probabilistic ladder waits for the probabilistic slice")
        for name, val, n in (("filters", filters, 5), ("se_reduction", se_reduction, 5),
                             ("strides", strides, 5), ("kernel_sizes", kernel_sizes, 5),
                             ("att_sub_samp", att_sub_samp, 4)):
            if len(val) != n or (name in ("strides", "kernel_sizes", "att_sub_samp")
                                 and any(len(v) != 3 for v in val)):
                raise ValueError(f"{name} needs {n} entries (3D ones for "
                                 f"strides/kernels/sub-sampling), got {val!r}")
        self.num_classes = num_classes
        self.conv_cfg = cfg = conv_cfg
        f, s, k, r = filters, strides, kernel_sizes, se_reduction

        def sers(cin, filt, kern, stride, red):
            return SEResNetBottleNeck(cin, filt, kern, stride, red, cfg)

        def drop(rate, site):
            return ConfigurableDropout(rate, dropout_mode, site)

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
        # Decoder stages 3..0 (networks.py:496-523): transposed conv, then an
        # SE block over the (deconv, gated skip) part list.
        self.convtd3 = ConvTranspose3d(f[4], f[3], k[4], s[4], cfg)
        self.sersd3 = sers(2 * f[3], f[3], k[3], (1, 1, 1), r[3])
        self.dropd3 = drop(dropout_rate, "dropd3")
        self.convtd2 = ConvTranspose3d(f[3], f[2], k[3], s[3], cfg)
        self.sersd2 = sers(2 * f[2], f[2], k[2], (1, 1, 1), r[2])
        self.dropd2 = drop(dropout_rate, "dropd2")
        self.convtd1 = ConvTranspose3d(f[2], f[1], k[2], s[2], cfg)
        self.sersd1 = sers(2 * f[1], f[1], k[1], (1, 1, 1), r[1])
        self.dropd1 = drop(dropout_rate, "dropd1")
        self.convtd0 = ConvTranspose3d(f[1], f[0], k[1], s[1], cfg)
        self.sersd0 = sers(2 * f[0], f[0], k[0], (1, 1, 1), r[0])
        self.dropd0 = drop(dropout_rate / 2, "dropd0")
        # Logits (networks.py:526).
        self.logits = Conv3d(f[0], num_classes, (1, 1, 1), (1, 1, 1), cfg)

    def trunk(self, inputs: torch.Tensor, train: bool = False,
              rng=None) -> Dict[str, Any]:
        """Stem -> encoder -> attention -> decoder -> logits (networks.py:
        568-630). The ``uconv*_`` entries are part tuples standing for the
        reference's stitch concats."""
        sa = lambda t: store_act(self.conv_cfg, t)  # noqa: E731
        if self.conv_cfg.dtype is not None:
            inputs = inputs.to(self.conv_cfg.dtype)
        d: Dict[str, Any] = {}
        x = sa(self.conve0(inputs))
        x = sa(self.norme0(x, lrelu=True))
        d["x"] = x

        conv1 = self.drope1(self.serse1(x), train, rng)
        conv2 = self.drope2(self.serse2(conv1), train, rng)
        conv3 = self.drope3(self.serse3(conv2), train, rng)
        convm = self.drope4(self.serse4(conv3), train, rng)
        d.update(conv1=conv1, conv2=conv2, conv3=conv3, convm=convm)

        att_conv0, att_0 = self.att0(x, convm)
        att_conv1, att_1 = self.att1(conv1, convm)
        att_conv2, att_2 = self.att2(conv2, convm)
        att_conv3, att_3 = self.att3(conv3, convm)
        att_conv0, att_conv1, att_conv2, att_conv3 = (
            sa(att_conv0), sa(att_conv1), sa(att_conv2), sa(att_conv3))
        d.update(att_conv0=att_conv0, att_conv1=att_conv1,
                 att_conv2=att_conv2, att_conv3=att_conv3,
                 att_map0=att_0, att_map1=att_1, att_map2=att_2, att_map3=att_3)

        uconv3_ = (sa(self.convtd3(convm)), att_conv3)
        uconv3 = self.dropd3(self.sersd3(uconv3_), train, rng)
        uconv2_ = (sa(self.convtd2(uconv3)), att_conv2)
        uconv2 = self.dropd2(self.sersd2(uconv2_), train, rng)
        uconv1_ = (sa(self.convtd1(uconv2)), att_conv1)
        uconv1 = self.dropd1(self.sersd1(uconv1_), train, rng)
        uconv0_ = (sa(self.convtd0(uconv1)), att_conv0)
        uconv0 = self.dropd0(self.sersd0(uconv0_), train, rng)
        d.update(uconv3_=uconv3_, uconv3=uconv3, uconv2_=uconv2_, uconv2=uconv2,
                 uconv1_=uconv1_, uconv1=uconv1, uconv0_=uconv0_, uconv0=uconv0)

        y__ = self.logits(uconv0)
        if self.num_classes > 1:
            y_ = torch.argmax(y__, dim=-1)
        else:
            y_ = (y__[..., 0] >= 0.5).to(torch.int32)
        d.update(logits=y__, y_=y_)
        return d

    def assemble_outputs(self, trunk: Dict[str, Any]) -> Dict[str, Any]:
        """Final output dict (networks.py:749-759), deep supervision off."""
        y__ = trunk["logits"]
        return dict(y_softmax=torch.softmax(y__, dim=-1),
                    y_sigmoid=torch.sigmoid(y__), logits=y__, y_=trunk["y_"])

    def forward(self, inputs: torch.Tensor, train: bool = False,
                rng=None) -> Dict[str, Any]:
        return self.assemble_outputs(self.trunk(inputs, train, rng))
