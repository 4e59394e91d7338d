"""M1 network wiring, port of the JAX package's ``models/m1_net.py``:
deterministic, hierarchical probabilistic and cascaded M1, and decision
fusion.

The probabilistic M1 runs a prior net on the image and a posterior net on
image + label (reference networks.py:296-391). Its five passes differ only
in the latent ladder, so with ``fused_prob_passes`` (the default) each
net's trunk runs once and the ladder once per pass; without it every pass
runs its own trunk, the reference's exact wiring with independent dropout
draws per pass. ``strict_reference_slicing`` keeps the reference's
posterior label slice ``inputs[..., -(nc-1)-1:-1]`` (networks.py:301), which
drops the label and feeds the last image channel; the default takes the
trailing nc-1 channels.

Torch modules take their input widths at construction: the prior takes
``input_channels - (num_classes - 1)`` channels, the posterior
``input_channels``, and stage 2 of a cascade ``input_channels +
num_classes - 1`` (stage 1's leading nc-1 softmax channels ++ image_2).

``detect`` runs only what the inference head returns (what JAX's jit
leaves of the full forward): no deep-supervision heads, and for a
probabilistic net the prior trunk, the prior's sampling ladder and the
final decoder, plus the posterior's mean pass where a cascade's stage 2
takes stage 1's ``prob_softmax``.

``sharded`` (``ops.normalization.ShardedStats``) is a forward argument
threaded down to every norm, squeeze and transposed conv, as ``rng`` is:
the JAX package's ``net.clone(sharded=...)`` for halo-sharded execution
(``parallel.halo``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .. import prng
from ..ops.distributions import kl_diag_gaussians
from ..ops.normalization import ShardedStats
from .blocks import StitchingProbDecoder
from .m1_core import M1Core

# pass: (net, where its latents come from), in the reference's order
# (networks.py:348-352); None samples, "mean" takes the means, a pass name
# injects that pass's latents
PASSES = {
    "q_sample": ("posterior", None),
    "q_mean": ("posterior", "mean"),
    "p_sample": ("prior", None),
    "p_sample_z_q": ("prior", "q_sample"),
    "p_sample_z_q_mean": ("prior", "q_mean"),
}


def decision_fusion(prior_softmax: torch.Tensor, follow_up_softmax: torch.Tensor,
                    strategy: str = "identity") -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage decision fusion (reference networks.py:208-223): the
    positive-class maps (B,D,H,W) of both stages -> two 2-channel maps
    (prior_pred, joint_pred)."""
    if strategy == "identity":
        joint = follow_up_softmax
    elif strategy == "noisy-or":
        joint = 1.0 - (1.0 - prior_softmax) * (1.0 - follow_up_softmax)
    elif strategy == "bayes":
        num = prior_softmax * follow_up_softmax + 1e-9
        den = num + (1.0 - prior_softmax) * (1.0 - follow_up_softmax)
        joint = num / den
    else:
        raise ValueError(f"Unknown fusion strategy: {strategy!r}")
    prior_pred = torch.stack([1.0 - prior_softmax, prior_softmax], dim=-1)
    return prior_pred, torch.stack([1.0 - joint, joint], dim=-1)


class M1Net(nn.Module):
    """Single-stage M1. ``forward(inputs, train, rng)`` returns the
    reference ``m1()`` dict: y_softmax / y_sigmoid / logits / y_, or for a
    probabilistic net prob_infer_conv / prob_train_conv / prob_kl /
    prob_softmax / infer_softmax."""

    def __init__(self, input_channels: int, num_classes: int = 2,
                 probabilistic: bool = False, prob_latent_dims=(1, 1, 1, 1),
                 deep_supervision: bool = False, fused_prob_passes: bool = True,
                 strict_reference_slicing: bool = False, **core_kwargs):
        super().__init__()
        self.num_classes = num_classes
        self.probabilistic = bool(probabilistic)
        self.deep_supervision = bool(deep_supervision)
        self.fused_prob_passes = bool(fused_prob_passes)
        self.strict_reference_slicing = bool(strict_reference_slicing)
        core_kwargs["num_classes"] = num_classes
        if not probabilistic:
            self.core = M1Core(input_channels, deep_supervision=deep_supervision,
                               **core_kwargs)
            return
        n_lbl = num_classes - 1
        prob = dict(probabilistic=True, prob_latent_dims=prob_latent_dims, **core_kwargs)
        self.prior = M1Core(input_channels - n_lbl, deep_supervision=deep_supervision, **prob)
        self.posterior = M1Core(input_channels, deep_supervision=False, **prob)
        self.final_decoder = StitchingProbDecoder(  # on the ladder's f[0] features
            self.prior.logits.kernel.shape[3], num_classes, self.prior.conv_cfg)

    # ------------------------------------------------------- probabilistic
    def _split(self, inputs: torch.Tensor):
        """(image, image ++ label) of a probabilistic net's input, each
        contiguous (the kernels take NDHWC tensors)."""
        n_lbl = self.num_classes - 1
        c = inputs.shape[-1]
        image = inputs[..., :c - n_lbl].contiguous()
        if self.strict_reference_slicing:
            label = inputs[..., c - n_lbl - 1:c - 1]  # reference defect
        else:
            label = inputs[..., c - n_lbl:]
        return image, torch.cat([image, label], dim=-1)

    def _passes(self, inputs, train, rng, wanted,
                sharded=None) -> Dict[str, Tuple[dict, dict]]:
        """(trunk, ladder output) of each pass in ``wanted`` and of the
        passes whose latents they take, run in the reference's order."""
        need = set(wanted)
        for name in wanted:
            src = PASSES[name][1]
            if src in PASSES:
                need.add(src)
        image, image_label = self._split(inputs)
        trunks, out = {}, {}
        for name, (net_name, src) in PASSES.items():
            if name not in need:
                continue
            net = getattr(self, net_name)
            x = image if net_name == "prior" else image_label
            if self.fused_prob_passes:
                if net_name not in trunks:
                    trunks[net_name] = net.trunk(x, train, prng.scope(rng, net_name), sharded)
                trunk = trunks[net_name]
            else:
                trunk = net.trunk(x, train, prng.scope(rng, name), sharded)
            z_q = out[src][1]["prob_used_latents"] if src in PASSES else None
            out[name] = (trunk, net.ladder(trunk, prob_mean=src == "mean", prob_z_q=z_q,
                                           train=train, rng=prng.scope(rng, name),
                                           sharded=sharded))
        return out

    def _prob_softmax(self, train_conv, p_zq_mean):
        soft = torch.softmax(train_conv, dim=-1)
        if not self.deep_supervision:
            return soft
        # networks.py:388-389: the mean-latent pass's deep-supervision softmaxes
        heads = self.prior.assemble_outputs(*p_zq_mean)["y_softmax"]
        return torch.cat([soft, heads[..., self.num_classes:]], dim=-1)

    def forward(self, inputs: torch.Tensor, train: bool = False, rng=None,
                sharded: Optional[ShardedStats] = None) -> Dict[str, Any]:
        if not self.probabilistic:
            out = self.core(inputs, train=train, rng=rng, sharded=sharded)
            return dict(y_softmax=out["y_softmax"], y_sigmoid=out["y_sigmoid"],
                        logits=out["logits"], y_=out["y_"])
        passes = self._passes(inputs, train, rng, tuple(PASSES), sharded)
        # latent-injected logits (networks.py:355-356)
        infer_conv = self.final_decoder(passes["p_sample"][1]["prob_decoder_features"])
        train_conv = self.final_decoder(
            passes["p_sample_z_q_mean"][1]["prob_decoder_features"])
        # KL(Q||P) per level: sum voxels, mean batch, sum levels (:373-385)
        kl_total = torch.zeros((), dtype=torch.float32, device=inputs.device)
        for q, p in zip(passes["q_sample"][1]["prob_distributions"],
                        passes["p_sample_z_q"][1]["prob_distributions"]):
            if q is None or p is None:
                continue
            kl_voxel = kl_diag_gaussians(q, p)
            kl_total = kl_total + torch.mean(
                torch.sum(kl_voxel, dim=tuple(range(1, kl_voxel.dim()))))
        return dict(prob_infer_conv=infer_conv, prob_train_conv=train_conv, prob_kl=kl_total,
                    prob_softmax=self._prob_softmax(train_conv, passes["p_sample_z_q_mean"]),
                    infer_softmax=torch.softmax(infer_conv, dim=-1))

    def detect(self, inputs: torch.Tensor, rng=None, with_prob_softmax: bool = False,
               sharded: Optional[ShardedStats] = None):
        """The inference head's output, computing only what it needs:
        ``y_softmax[..., :nc]`` (the logits' softmax: no deep-supervision
        heads), or for a probabilistic net ``infer_softmax``. With
        ``with_prob_softmax`` also the leading nc channels of
        ``prob_softmax`` (what a cascade's stage 2 takes): ``(infer,
        prob)``."""
        if not self.probabilistic:
            soft = torch.softmax(self.core.trunk(inputs, False, rng, sharded)["logits"], dim=-1)
            return (soft, soft) if with_prob_softmax else soft
        wanted = ("p_sample", "p_sample_z_q_mean") if with_prob_softmax else ("p_sample",)
        passes = self._passes(inputs, False, rng, wanted, sharded)
        infer = torch.softmax(self.final_decoder(
            passes["p_sample"][1]["prob_decoder_features"]), dim=-1)
        if not with_prob_softmax:
            return infer
        train_conv = self.final_decoder(passes["p_sample_z_q_mean"][1]["prob_decoder_features"])
        return infer, torch.softmax(train_conv, dim=-1)


class M1CascadedNet(nn.Module):
    """Two-stage cascaded M1 with decision fusion (reference networks.py:
    108-193). ``forward((image_1, image_2), train, rng)`` returns
    detection_1/_2 and both stages' outputs (+ KL_1/_2 and the inference
    fusions when probabilistic). Stage 2 takes stage 1's leading nc-1
    softmax channels ++ image_2 (networks.py:135-136)."""

    def __init__(self, input_channels: int, num_classes: int = 2,
                 fusion: str = "identity", **stage_kwargs):
        super().__init__()
        if fusion not in ("identity", "noisy-or", "bayes"):
            raise ValueError(f"Unknown fusion strategy: {fusion!r}")
        self.num_classes, self.fusion = num_classes, fusion
        self.stage1 = M1Net(input_channels, num_classes, **stage_kwargs)
        self.stage2 = M1Net(input_channels + num_classes - 1, num_classes, **stage_kwargs)
        self.probabilistic = self.stage1.probabilistic

    def _stage2_input(self, s1_soft, image_2):
        lead = s1_soft[..., :self.num_classes - 1]
        dt = torch.promote_types(lead.dtype, image_2.dtype)
        return torch.cat([lead.to(dt), image_2.to(dt)], dim=-1)

    def forward(self, inputs, train: bool = False, rng=None,
                sharded: Optional[ShardedStats] = None) -> Dict[str, Any]:
        image_1, image_2 = inputs
        nc, prob = self.num_classes, self.probabilistic
        out1 = self.stage1(image_1, train=train, rng=prng.scope(rng, "stage1"),
                           sharded=sharded)
        s1_soft = out1["prob_softmax"] if prob else out1["y_softmax"]
        out2 = self.stage2(self._stage2_input(s1_soft, image_2), train=train,
                           rng=prng.scope(rng, "stage2"), sharded=sharded)
        s2_soft = out2["prob_softmax"] if prob else out2["y_softmax"]
        prior_train, joint_train = decision_fusion(s1_soft[..., nc - 1], s2_soft[..., nc - 1],
                                                   self.fusion)
        outputs: Dict[str, Any] = dict(detection_1=prior_train, detection_2=joint_train,
                                       stage1=out1, stage2=out2)
        if prob:
            inf1, inf2 = out1["infer_softmax"], out2["infer_softmax"]
            prior_inf, joint_inf = decision_fusion(inf1[..., nc - 1], inf2[..., nc - 1],
                                                   self.fusion)
            outputs.update(KL_1=out1["prob_kl"], KL_2=out2["prob_kl"],
                           infer_softmax_1=inf1, infer_softmax_2=inf2,
                           infer_detection_1=prior_inf, infer_detection_2=joint_inf)
        return outputs

    def detect(self, inputs, rng=None, sharded: Optional[ShardedStats] = None):
        """(stage 1, stage 2) as the inference head returns them:
        y_softmax[..., :nc] of each stage, or each stage's infer_softmax
        for probabilistic stages (stage 2 still takes stage 1's
        prob_softmax)."""
        image_1, image_2 = inputs
        infer1, soft1 = self.stage1.detect(image_1, prng.scope(rng, "stage1"),
                                           with_prob_softmax=True, sharded=sharded)
        out2 = self.stage2.detect(self._stage2_input(soft1, image_2),
                                  prng.scope(rng, "stage2"), sharded=sharded)
        return infer1, out2
