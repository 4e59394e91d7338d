"""M1, the top-level model with the reference's constructor surface: port of
the JAX package's ``models/m1.py`` for single-stage models, Monte-Carlo
dropout included.

``M1`` wraps an ``nn.Module`` (``.net``) whose parameters are fp32 and live
on ``device``; ``dtype`` (e.g. ``torch.bfloat16``) is the compute type, cast
at apply time as the JAX package does. Checkpoints are the JAX package's
npz files: ``M1.load`` reads what the JAX ``M1.save`` writes and the other
way round. ``config`` holds exactly the JAX config keys; ``device`` and
``dtype`` are load-time choices and are not stored.

Random bits come from an explicit ``rng`` (see ``prng``): a
``torch.Generator`` on the model's device, an int seed, or a mapping from
dropout site to keep-mask. ``__call__`` and ``predict`` draw a fresh seed
when an always-on (monte-carlo) model gets none, as the JAX package does;
``apply`` and the detect head raise instead.

Not in this slice (each raises ``NotImplementedError``): cascaded models,
probabilistic models, dense skips and deep supervision. ``get_packed_forward``
is a TPU layout device and is not ported. ``remat`` is a training memory
knob and changes nothing at inference.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..bridge import from_jax_params, to_jax_params
from ..device import resolve_device
from ..ops.convolution import (INITIALIZERS, Conv3d, ConvConfig, ConvTranspose3d,
                               resolve_initializer)
from ..ops.normalization import InstanceNorm
from .blocks import SqueezeConv
from .m1_net import M1Net


def _resolve_l2(spec, default=1e-4) -> float:
    if spec is None:
        return 0.0
    if isinstance(spec, (int, float)):
        return float(spec)
    return default


def _as_nested_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_as_nested_tuple(e) for e in x)
    return x


def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    got = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return got


def _dtype_name(dtype) -> Optional[str]:
    return None if dtype is None else str(_torch_dtype(dtype)).replace("torch.", "")


def m1(input_channels: int, num_classes: int = 2,
       dropout_mode: str = "standard", dropout_rate: float = 0.50,
       filters=(32, 64, 128, 256, 512),
       strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
       kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
       se_reduction=(8, 8, 8, 8, 8),
       att_sub_samp=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
       kernel_initializer=None, bias_initializer=None,
       kernel_regularizer=1e-4, bias_regularizer=1e-4,
       dense_skip: bool = False, deep_supervision: bool = False,
       probabilistic: bool = False, act_store: Any = None, dtype: Any = None,
       **_ignored) -> M1Net:
    """Mid-level factory (reference networks.py:232-392): the module."""
    conv_cfg = ConvConfig(kernel_init=kernel_initializer or "orthogonal",
                          bias_init=bias_initializer or "truncated_normal",
                          kernel_l2=_resolve_l2(kernel_regularizer),
                          bias_l2=_resolve_l2(bias_regularizer),
                          dtype=_torch_dtype(dtype), act_store=act_store)
    return M1Net(
        input_channels, probabilistic=probabilistic, num_classes=num_classes,
        dropout_mode=dropout_mode, dropout_rate=dropout_rate,
        filters=_as_nested_tuple(filters), strides=_as_nested_tuple(strides),
        kernel_sizes=_as_nested_tuple(kernel_sizes),
        se_reduction=_as_nested_tuple(se_reduction),
        att_sub_samp=_as_nested_tuple(att_sub_samp), conv_cfg=conv_cfg,
        dense_skip=dense_skip, deep_supervision=deep_supervision)


class M1:
    """Top-level model with the reference's Keras-style surface
    (networks.py:24-223): constructor kwargs, ``get_detect_model``,
    ``predict``, ``save``/``load``/``load_weights``."""

    def __init__(
        self,
        input_spatial_dims: Sequence[int],
        input_channels: int,
        num_classes: int,
        dropout_rate: float = 0.50,
        dropout_mode: str = "standard",
        filters=(32, 64, 128, 256, 512),
        strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
        kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
        se_reduction=(8, 8, 8, 8, 8),
        att_sub_samp=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
        kernel_initializer=None,
        bias_initializer=None,
        kernel_regularizer=1e-4,
        bias_regularizer=1e-4,
        cascaded=False,
        dense_skip: bool = False,
        deep_supervision: bool = False,
        probabilistic: bool = False,
        prob_latent_dims=(3, 2, 1),
        summary: bool = True,
        name: str = "UNET-TYPE-M1",
        fused_prob_passes: bool = True,
        strict_reference_slicing: bool = False,
        remat: bool = False,
        act_store: Any = None,
        dtype: Any = None,
        seed: int = 0,
        init_params: bool = True,
        device="cuda",
    ):
        if len(input_spatial_dims) != 3:
            raise ValueError(f"M1 takes 3 spatial dims, got {input_spatial_dims!r}")
        dev = resolve_device(device)
        if cascaded:
            raise NotImplementedError("cascaded M1 waits for the cascade slice")
        if probabilistic:
            raise NotImplementedError(
                "probabilistic M1 waits for the probabilistic slice")

        # store_config_args parity (modelio.py:20-55): the JAX config keys
        self.config: Dict[str, Any] = dict(
            input_spatial_dims=tuple(input_spatial_dims),
            input_channels=input_channels,
            num_classes=num_classes,
            dropout_rate=dropout_rate,
            dropout_mode=dropout_mode,
            filters=_as_nested_tuple(filters),
            strides=_as_nested_tuple(strides),
            kernel_sizes=_as_nested_tuple(kernel_sizes),
            se_reduction=_as_nested_tuple(se_reduction),
            att_sub_samp=_as_nested_tuple(att_sub_samp),
            kernel_initializer=kernel_initializer if isinstance(
                kernel_initializer, (str, type(None))) else "orthogonal",
            bias_initializer=bias_initializer if isinstance(
                bias_initializer, (str, type(None))) else "truncated_normal",
            kernel_regularizer=_resolve_l2(kernel_regularizer),
            bias_regularizer=_resolve_l2(bias_regularizer),
            cascaded=cascaded,
            dense_skip=dense_skip,
            deep_supervision=deep_supervision,
            probabilistic=probabilistic,
            prob_latent_dims=_as_nested_tuple(prob_latent_dims),
            summary=summary,
            name=name,
            fused_prob_passes=fused_prob_passes,
            strict_reference_slicing=strict_reference_slicing,
            remat=remat,
            act_store=_dtype_name(act_store),
            seed=seed,
        )
        self.name = name
        self.cascaded = cascaded
        self.probabilistic = probabilistic
        self.num_classes = num_classes
        self.input_spatial_dims = tuple(input_spatial_dims)
        self.input_channels = input_channels
        self.device = dev
        self.dtype = _torch_dtype(dtype)
        self._net_kwargs = dict(
            input_channels=input_channels, num_classes=num_classes,
            dropout_mode=dropout_mode, dropout_rate=dropout_rate,
            filters=filters, strides=strides, kernel_sizes=kernel_sizes,
            se_reduction=se_reduction, att_sub_samp=att_sub_samp,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer,
            kernel_regularizer=kernel_regularizer,
            bias_regularizer=bias_regularizer, dense_skip=dense_skip,
            deep_supervision=deep_supervision, act_store=self.config["act_store"],
            dtype=self.dtype)
        with torch.device(dev):
            self.net = m1(**self._net_kwargs)
        self.net.eval()
        if init_params:
            self.init(seed)
        if summary:
            self.summary()

    # ------------------------------------------------------------ params
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The live parameters as a state dict (tensors share storage)."""
        return self.net.state_dict()

    @params.setter
    def params(self, state: Dict[str, Any]) -> None:
        self.net.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
             for k, v in state.items()})

    def to(self, device) -> "M1":
        self.device = resolve_device(device)
        self.net.to(self.device)
        return self

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """(Re)initialize every parameter from ``seed`` with the reference's
        initializers: orthogonal conv kernels, truncated-normal (0.001) conv
        biases, glorot-uniform SE kernels with zero bias, IN scale 1 and
        bias 0. The draws come from a ``torch.Generator``, so they differ
        from the JAX package's for the same seed."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.net.modules():
                if isinstance(mod, (Conv3d, ConvTranspose3d)):
                    kinit = resolve_initializer(mod.cfg.kernel_init)
                    mod.kernel.copy_(kinit(tuple(mod.kernel.shape), gen))
                    if mod.bias is not None:
                        binit = resolve_initializer(mod.cfg.bias_init)
                        mod.bias.copy_(binit(tuple(mod.bias.shape), gen))
                elif isinstance(mod, SqueezeConv):
                    mod.kernel.copy_(INITIALIZERS["glorot_uniform"](
                        tuple(mod.kernel.shape), gen))
                    mod.bias.zero_()
                elif isinstance(mod, InstanceNorm):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()
        return self.params

    # ----------------------------------------------------------- forward
    def _as_input(self, inputs) -> torch.Tensor:
        if not torch.is_tensor(inputs):
            inputs = torch.from_numpy(np.ascontiguousarray(inputs, np.float32))
        return inputs.to(self.device).contiguous()

    @property
    def stochastic(self) -> bool:
        """Dropout stays on at inference (the CLI default, cli.py:76-77)."""
        return self.config["dropout_mode"] == "monte-carlo"

    def apply(self, params, inputs, train: bool = False, rng=None):
        """Forward pass (inference only in this slice: runs without
        autograd). ``params`` None uses the model's own; a state dict runs
        those instead. ``rng`` feeds the dropout sites; active dropout
        without one raises."""
        x = self._as_input(inputs)
        rng = prng.as_rng(rng, self.device)
        with torch.no_grad():
            if params is None:
                return self.net(x, train, rng)
            return torch.func.functional_call(self.net, params, (x,),
                                              {"train": train, "rng": rng})

    def __call__(self, inputs, train: bool = False, rng=None):
        if rng is None and (self.stochastic or train):
            rng = prng.fresh(self.device)
        return self.apply(None, inputs, train=train, rng=rng)

    def get_detect_model(self) -> Callable:
        """Inference head (reference networks.py:196-206):
        ``detect(params, inputs, rng=None) -> y_softmax[..., :num_classes]``."""
        nc = self.num_classes

        def detect(params, inputs, rng=None):
            return self.apply(params, inputs, train=False, rng=rng)[
                "y_softmax"][..., :nc]

        return detect

    def predict(self, inputs, rng=None) -> torch.Tensor:
        if rng is None and self.stochastic:  # self-key, as ``__call__``
            rng = prng.fresh(self.device)
        return self.get_detect_model()(None, inputs, rng=rng)

    # -------------------------------------------------------------- io
    def save(self, path: str) -> None:
        from ..utils.serialization import save_model

        save_model(path, self.config, to_jax_params(self.net))

    def load_weights(self, path: str, strict: bool = False) -> "M1":
        """Load checkpoint weights into this architecture, matched by
        keypath; leaves missing from the checkpoint or of another shape keep
        their values (``strict=True`` raises instead)."""
        from ..utils.serialization import load_model

        _, saved = load_model(path)
        flat = from_jax_params(saved)
        skipped = []
        with torch.no_grad():
            for key, leaf in self.net.state_dict().items():
                got = flat.pop(key, None)
                if got is not None and tuple(got.shape) == tuple(leaf.shape):
                    leaf.copy_(got)
                else:
                    skipped.append(key)
        unused = sorted(flat)
        if strict and (skipped or unused):
            raise ValueError(
                f"load_weights(strict=True): unmatched target leaves {skipped}, "
                f"unused checkpoint leaves {unused}")
        if skipped or unused:
            print(f"load_weights: kept init for {len(skipped)} leaves, "
                  f"ignored {len(unused)} checkpoint leaves (head/arch mismatch)")
        return self

    @classmethod
    def load(cls, path: str, **overrides) -> "M1":
        """Rebuild the architecture from the stored config, then load the
        weights (reference modelio.py:98-117). ``overrides`` may add
        ``device=`` and ``dtype=`` (e.g. ``torch.bfloat16``)."""
        from ..utils.serialization import load_model

        config, params = load_model(path)
        config = dict(config)
        config.update(overrides)
        config["summary"] = False
        config["init_params"] = False
        model = cls(**config)
        model.params = from_jax_params(params)
        return model

    # ---------------------------------------------------------- summary
    def describe(self, batch_size: int = 1, max_lines: int = 200):
        """Per-module output-shape dump (reference M1Core.summary), traced
        on the meta device: no compute, no memory."""
        with torch.device("meta"):
            net = m1(**self._net_kwargs)
        lines = []

        def hook(name):
            def record(_mod, _inp, out):
                leaves = out if isinstance(out, (tuple, list)) else (out,)
                for i, t in enumerate(leaves):
                    if torch.is_tensor(t):
                        tag = f"{name}/{i}" if len(leaves) > 1 else name
                        lines.append(f"{tag:60s} {tuple(t.shape)}")
            return record

        for n, mod in net.named_modules():
            if n:
                mod.register_forward_hook(hook(n.replace(".", "/")))
        x = torch.zeros((batch_size, *self.input_spatial_dims,
                         self.input_channels), device="meta")
        with torch.no_grad():
            net(x)
        for line in lines[:max_lines]:
            print(line)
        if len(lines) > max_lines:
            print(f"... ({len(lines) - max_lines} more)")
        return lines

    def summary(self):
        n_params = sum(p.numel() for p in self.net.parameters())
        print("-" * 68)
        print(f"Deterministic 3D U-Net (Type: M1)  —  params: {n_params:,}")
        print(f"Input: {self.input_spatial_dims} x {self.input_channels}ch  "
              f"classes: {self.num_classes}  device: {self.device}")
        print("-" * 68)
