"""Per-voxel diagonal Gaussians with a closed-form KL, port of the JAX
package's ``ops/distributions.py`` (the latents of the probabilistic
ladder). The event axis is the trailing (latent) one; the batch shape is
(B, D, H, W).

log-sigma is clipped to [-0.1, 0.1] before it is exponentiated (the
reference's guard against KL blow-up). Sampling is reparameterized with an
explicit ``torch.Generator`` (or given draws, ``prng.Draws``): ``loc +
scale * eps`` with ``eps`` drawn in fp32 and cast to the location's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..prng import normal

LOGSIG_CLIP = 0.1


class DiagGaussian(NamedTuple):
    """loc and scale per voxel; the event shape is the trailing axis."""

    loc: torch.Tensor    # (..., latent_dim)
    scale: torch.Tensor  # (..., latent_dim), strictly positive

    @classmethod
    def from_mu_logsigma(cls, mu: torch.Tensor, logsigma: torch.Tensor) -> "DiagGaussian":
        return cls(loc=mu, scale=torch.exp(torch.clamp(logsigma, -LOGSIG_CLIP, LOGSIG_CLIP)))

    def sample(self, generator, site: str = "z") -> torch.Tensor:
        """A reparameterized draw; ``generator`` is a ``torch.Generator`` or
        ``prng.Draws`` (which names the draw ``site``)."""
        eps = normal(generator, self.loc.shape, self.loc.device, site)
        return self.loc + self.scale * eps.to(self.loc.dtype)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc


def kl_diag_gaussians(q: DiagGaussian, p: DiagGaussian) -> torch.Tensor:
    """KL(q || p) summed over the event axis, in fp32 whatever the inputs'
    dtype (the per-voxel KL is summed over every voxel downstream). Per
    dimension: log(sp/sq) + (sq^2 + (mq - mp)^2) / (2 sp^2) - 1/2."""
    qloc, qsc = q.loc.float(), q.scale.float()
    ploc, psc = p.loc.float(), p.scale.float()
    var_ratio = torch.square(qsc / psc)
    t1 = torch.square((qloc - ploc) / psc)
    return torch.sum(0.5 * (var_ratio + t1 - 1.0) - torch.log(qsc / psc), dim=-1)
