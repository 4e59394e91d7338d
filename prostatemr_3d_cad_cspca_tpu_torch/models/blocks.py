"""Network building blocks of the M1 path, port of the JAX package's
``models/blocks.py`` (reference network_blocks.py).

Torch modules need their input widths at construction, where flax infers
them at the first call; every block here takes them explicitly. Parameter
names match the flax tree (``conv1/kernel``, ``norm1/scale``,
``se_conv6/kernel`` ...), so the bridge maps one onto the other by name.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convolution import Conv3d, ConvConfig, store_act
from ..ops.normalization import InstanceNorm, ShardedStats, global_spatial_mean
from ..ops.resample import upsample_nearest
from ..prng import Draws, is_mask_map, uniform
from ..utils.profiling import annotate


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), the sole activation of the reference backbone."""
    return F.leaky_relu(x, 0.1)


def dropout(x: torch.Tensor, rate: float, rng, site: Optional[str] = None
            ) -> torch.Tensor:
    """Active dropout exactly as flax ``nn.Dropout``: ``keep = 1 - rate``, a
    Bernoulli(keep) mask, ``where(mask, x / keep, 0)`` in x's dtype (keep is
    rounded to that dtype first, as a weakly typed JAX scalar is); rate 0 is
    the identity and rate 1 gives zeros.

    ``rng`` is a ``torch.Generator`` on x's device or ``prng.Draws``,
    whose uniform draws below ``keep`` are the mask, or a mapping from
    dropout ``site`` to a keep-mask of x's shape, which is replayed and
    draws nothing (see ``prng`` for the sites' paths)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    with annotate("m1.dropout"):  # the draw (or replayed mask) and the where
        if is_mask_map(rng):
            if site not in rng:
                raise KeyError(f"no keep-mask for dropout site {site!r}")
            mask = torch.as_tensor(rng[site], device=x.device).to(torch.bool)
            if tuple(mask.shape) != tuple(x.shape):
                raise ValueError(f"keep-mask of {site!r} has shape {tuple(mask.shape)}, "
                                 f"the activation {tuple(x.shape)}")
        elif isinstance(rng, (torch.Generator, Draws)):
            mask = uniform(rng, x.shape, x.device, site) < keep
        else:
            raise ValueError(f"dropout at rate {rate} needs rng: a torch.Generator on "
                             f"{x.device} or a mapping of keep-masks")
        # a 0-dim tensor on x's device: CUDA would turn a Python scalar divisor
        # into a multiply by its reciprocal, which rounds differently
        scale = torch.full((), keep, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


class ConfigurableDropout(nn.Module):
    """Dropout that is train-gated ('standard') or always on ('monte-carlo')
    (JAX ``blocks.py:33-50``). ``site`` names it in a mapping of keep-masks."""

    def __init__(self, rate: float, mode: str = "standard", site: Optional[str] = None):
        super().__init__()
        self.rate, self.mode, self.site = float(rate), mode, site

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        if self.rate == 0.0 or (self.mode == "standard" and not train):
            return x
        return dropout(x, self.rate, rng, self.site)


class MonteCarloDropout(nn.Module):
    """Always-active dropout (JAX ``blocks.py:53-63``)."""

    def __init__(self, rate: float, site: Optional[str] = None):
        super().__init__()
        self.rate, self.site = float(rate), site

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        del train
        return dropout(x, self.rate, rng, self.site)


class SqueezeConv(nn.Module):
    """A (1,1,1) conv on the (B,1,1,1,C) SE squeeze, run as ``F.linear``
    (flax ``nn.Conv``; the JAX package leaves it to XLA likewise)."""

    def __init__(self, in_channels: int, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(1, 1, 1, in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype is not None else torch.promote_types(
            s.dtype, self.kernel.dtype)
        w = self.kernel.reshape(self.kernel.shape[3], self.kernel.shape[4])
        return F.linear(s.to(dt), w.t().to(dt), self.bias.to(dt))


class SEResNetBottleNeck(nn.Module):
    """SE-ResNet bottleneck (JAX ``blocks.py:66-151``).

    conv(f/4, k, s) -> IN -> LReLU -> conv(f/4, 3^3) -> IN -> LReLU ->
    conv(f, 1^3) -> IN; projection conv(f, k, s) + IN when the channel count
    changes; squeeze-excite gate; the gated features combine with the
    shortcut by MULTIPLY (reference quirk, kept), then LReLU. The input may
    be a part list standing for its channel concat. ``sharded`` gives every
    norm and the squeeze whole-volume statistics (halo sharding).
    """

    def __init__(self, in_channels: int, filters: int, kernel_size, strides,
                 reduction: int, conv_cfg: ConvConfig = ConvConfig()):
        super().__init__()
        cfg = self.conv_cfg = conv_cfg
        ks, st = tuple(kernel_size), tuple(strides)
        q = filters // 4
        self.in_channels = in_channels
        self.conv1 = Conv3d(in_channels, q, ks, st, cfg)
        self.norm1 = InstanceNorm(q)
        self.conv2 = Conv3d(q, q, (3, 3, 3), (1, 1, 1), cfg)
        self.norm2 = InstanceNorm(q)
        self.conv3 = Conv3d(q, filters, (1, 1, 1), (1, 1, 1), cfg)
        self.norm3 = InstanceNorm(filters)
        if in_channels != filters:
            self.conv4 = Conv3d(in_channels, filters, ks, st, cfg)
            self.norm4 = InstanceNorm(filters)
        else:
            self.conv4 = self.norm4 = None
        self.se_conv6 = SqueezeConv(filters, filters // reduction, cfg.dtype)
        self.se_conv7 = SqueezeConv(filters // reduction, filters, cfg.dtype)

    def _over_parts(self, conv: Conv3d, parts) -> torch.Tensor:
        """``conv`` of the block's input; over a part list (a decoder or
        ladder stitch) inside the ``m1.stitch`` span."""
        if len(parts) == 1:
            return conv(parts)
        with annotate("m1.stitch", {"parts": len(parts), "cin": self.in_channels}):
            return conv(parts)

    def forward(self, x, sharded: Optional[ShardedStats] = None) -> torch.Tensor:
        cfg = self.conv_cfg
        parts = list(x) if isinstance(x, (list, tuple)) else [x]
        h = store_act(cfg, self._over_parts(self.conv1, parts))
        h = self.norm1(h, lrelu=True, sharded=sharded)
        h = store_act(cfg, self.conv2(h))
        h = self.norm2(h, lrelu=True, sharded=sharded)
        h = store_act(cfg, self.conv3(h))
        x_ = self.norm3(h, sharded=sharded)
        if self.conv4 is not None:
            residual = self.norm4(store_act(cfg, self._over_parts(self.conv4, parts)),
                                  sharded=sharded)
        else:
            residual = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        with annotate("m1.se"):  # the squeeze-excite tail
            s = global_spatial_mean(x_, sharded).to(x_.dtype)
            s = torch.sigmoid(self.se_conv7(leaky_relu01(self.se_conv6(s))))
            out = (x_ * s) * residual
            return store_act(cfg, leaky_relu01(out))


class GridAttentionBlock3D(nn.Module):
    """Grid attention gate (JAX ``blocks.py:154-191``). Returns (gated
    features, attention map)."""

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, sub_samp: Sequence[int],
                 conv_cfg: ConvConfig = ConvConfig()):
        super().__init__()
        sub = tuple(sub_samp)
        self.theta = Conv3d(in_channels, inter_channels, sub, sub, conv_cfg)
        self.phi = Conv3d(gating_channels, inter_channels, (1, 1, 1), (1, 1, 1),
                          conv_cfg)
        self.psi = Conv3d(inter_channels, 1, (1, 1, 1), (1, 1, 1), conv_cfg)
        self.out = Conv3d(in_channels, inter_channels, (1, 1, 1), (1, 1, 1),
                          conv_cfg)
        self.norm_out = InstanceNorm(inter_channels)

    def forward(self, x: torch.Tensor, g: torch.Tensor,
                sharded: Optional[ShardedStats] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        with annotate("m1.gate"):
            theta_x = self.theta(x)
            phi_g = self.phi(g)
            up1 = tuple(theta_x.shape[i + 1] // phi_g.shape[i + 1] for i in range(3))
            f = leaky_relu01(theta_x + upsample_nearest(phi_g, up1))
            sigm_psi_f = torch.sigmoid(self.psi(f))
            up2 = tuple(x.shape[i + 1] // sigm_psi_f.shape[i + 1] for i in range(3))
            sigm_psi_f = upsample_nearest(sigm_psi_f, up2)
            w_y = self.norm_out(self.out(sigm_psi_f * x), sharded=sharded)
            return w_y, sigm_psi_f


class StitchingProbDecoder(nn.Module):
    """Final 1x1x1 logits over the ladder's decoder features (JAX
    ``blocks.py:194-205``; parameters ``logits/kernel``, ``logits/bias``)."""

    def __init__(self, in_channels: int, num_classes: int,
                 conv_cfg: ConvConfig = ConvConfig()):
        super().__init__()
        self.logits = Conv3d(in_channels, num_classes, (1, 1, 1), (1, 1, 1), conv_cfg)

    def forward(self, decoder_features: torch.Tensor) -> torch.Tensor:
        return self.logits(decoder_features)
