"""The published training step in plain PyTorch and fp32: the lesion
task's labels (GGG >= 2, each axial slice's contour smoothed by a 7x7
Gaussian blur and rounded: the reference's ``cv2.GaussianBlur(label, (7,
7), cv2.BORDER_DEFAULT)``, whose third argument is sigmaX, so sigma 4), the on-device augmentation, the forward in
training mode (dropout drawn), focal loss + L2 on every conv, the gradient
by autograd and Keras's Adam with amsgrad (reference ``train_model.py``,
``losses.py``; tf.keras ``optimizer_v2/adam.py``).

Data order: the data layer shuffles its cases once an epoch with one
``np.random.default_rng(shuffle_seed)`` and stacks consecutive samples into
batches. Draws: a step's dropout from the step's generator, its
augmentation from ``fold_in(step seed, AUGMENT_FOLD)`` (``draws``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import augment, draws
from .m1 import to_ncdhw, to_ndhwc, train_probs

EPSILON = 1e-7  # tf.keras.backend.epsilon()


SIGMA = 4.0  # cv2.BORDER_DEFAULT, passed where cv2 takes sigmaX


def _blur_kernel(ksize: int = 7, sigma: float = SIGMA) -> np.ndarray:
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def smooth(mask: np.ndarray, ksize: int = 7) -> np.ndarray:
    """Each (H, W) slice of a (D, H, W) 0/1 mask blurred (reflect-101
    border) and rounded."""
    k = _blur_kernel(ksize)
    pad = ksize // 2
    x = np.pad(mask.astype(np.float64), ((0, 0), (pad, pad), (pad, pad)), mode="reflect")
    h, w = mask.shape[1:]
    y = sum(k[i] * x[:, i:i + h, :] for i in range(ksize))
    y = sum(k[i] * y[:, :, i:i + w] for i in range(ksize))
    return np.rint(y)


def sample(image_path: str, label_path: str):
    """(image (D, H, W, C) fp32, one-hot label (D, H, W, 2) fp32)."""
    image = np.load(image_path).astype(np.float32)
    lesion = (np.load(label_path) >= 2).astype(np.float32)
    lesion = smooth(lesion).astype(np.float32)
    return image, np.stack([1.0 - lesion, lesion], axis=-1)


def order(n: int, shuffle_seed: int, count: int) -> List[int]:
    """The first ``count`` samples' case indices."""
    rng = np.random.default_rng(shuffle_seed)
    out: List[int] = []
    while len(out) < count:
        idx = np.arange(n)
        rng.shuffle(idx)
        out.extend(int(i) for i in idx)
    return out[:count]


def focal(y_true: torch.Tensor, y_pred: torch.Tensor, alpha, gamma: float) -> torch.Tensor:
    """Sum over voxels and classes, mean over the batch."""
    w = torch.tensor(alpha, dtype=torch.float32, device=y_pred.device)
    y_pred = y_pred / torch.sum(y_pred, dim=-1, keepdim=True)
    lo = torch.tensor(EPSILON, device=y_pred.device)
    hi = torch.tensor(1.0 - EPSILON, device=y_pred.device)
    y_pred = torch.minimum(torch.maximum(y_pred, lo), hi)
    fl = w * y_true * torch.pow(1.0 - y_pred, gamma) * (y_true * -torch.log(y_pred))
    return torch.mean(torch.sum(fl, dim=tuple(range(1, fl.dim()))))


def l2(params: Dict[str, torch.Tensor], kernel_l2: float, bias_l2: float) -> torch.Tensor:
    """L2 on every conv's kernel and bias; the instance norms' affine and
    the squeeze-excite convs carry none."""
    total = 0.0
    for name, leaf in params.items():
        path = name.split(".")
        if path[-2].startswith(("norm", "se_")) or path[-1] not in ("kernel", "bias"):
            continue
        total = total + (kernel_l2 if path[-1] == "kernel" else bias_l2) * leaf.square().sum()
    return total


class Amsgrad:
    """tf.keras Adam(amsgrad=True): the max over the raw second moment, eps
    outside the square root, the bias correction folded into the rate."""

    def __init__(self, lr=1e-3, b1=0.9, b2=0.999, eps=1e-7):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t, self.m, self.v, self.vhat = 0, {}, {}, {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        c = torch.tensor(float(self.t), dtype=torch.float32)
        bc = float(torch.sqrt(1.0 - self.b2 ** c) / (1.0 - self.b1 ** c))
        with torch.no_grad():
            for k, g in grads.items():
                m = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
                v = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
                vhat = torch.maximum(self.vhat.get(k, torch.zeros_like(g)), v)
                self.m[k], self.v[k], self.vhat[k] = m, v, vhat
                params[k] -= self.lr * (m * bc / (torch.sqrt(vhat) + self.eps))


def steps(params0: Dict[str, torch.Tensor], cfg: dict, train: dict, batches: Sequence,
          step_seeds: Sequence[int], device):
    """The first ``len(batches)`` steps from ``params0``: (losses, the
    first step's gradients, the parameters after the last step).
    ``batches``: (image, label) host arrays (B, D, H, W, C) each."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    opt = Amsgrad(lr=train["learning_rate"])
    losses, first = [], None
    for (image, label), seed in zip(batches, step_seeds):
        img = torch.from_numpy(image).to(device)
        lbl = torch.from_numpy(label).to(device)
        img, lbl = augment.augment(draws.Stream(draws.fold_in(seed, draws.AUGMENT_FOLD),
                                                device), img, lbl, train["augm_params"])
        probs = to_ndhwc(train_probs(params, cfg, to_ncdhw(img), draws.Stream(seed, device)))
        loss = focal(lbl, probs, train["focal_alpha"], train["focal_gamma"]) \
            + l2(params, cfg["kernel_regularizer"], cfg["bias_regularizer"])
        keys = list(params)
        grads = dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        del probs, loss, grads, img, lbl
    return losses, first, {k: v.detach() for k, v in params.items()}


def median_norm(tree: Dict[str, torch.Tensor]) -> float:
    return float(np.median([float(t.double().norm()) for t in tree.values()]))


def moved_leaves(first_grads: Dict[str, torch.Tensor], rel: float = 1e-3) -> List[str]:
    """The leaves whose first gradient is not nought to rounding: a norm of
    at least ``rel`` of the median leaf's."""
    med = median_norm(first_grads)
    return [k for k, g in first_grads.items() if float(g.double().norm()) >= rel * med]
