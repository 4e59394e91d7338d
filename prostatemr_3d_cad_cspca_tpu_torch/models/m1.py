"""M1, the top-level model with the reference's constructor surface: port of
the JAX package's ``models/m1.py``: deterministic, Monte-Carlo dropout,
dense skips and deep supervision, the hierarchical probabilistic ladder and
the two-stage cascade (``cascaded`` True or a fusion name).

``M1`` wraps an ``nn.Module`` (``.net``) whose parameters are fp32 and live
on ``device``; ``dtype`` (e.g. ``torch.bfloat16``) is the compute type, cast
at apply time as the JAX package does. Checkpoints are the JAX package's
npz files: ``M1.load`` reads what the JAX ``M1.save`` writes and the other
way round. ``config`` holds exactly the JAX config keys; ``device`` and
``dtype`` are load-time choices and are not stored.

Random bits come from an explicit ``rng`` (see ``prng``): a
``torch.Generator`` on the model's device, an int seed, or a mapping of
keep-masks and latents. ``__call__`` and ``predict`` draw a fresh seed when
a probabilistic or always-on (monte-carlo) model gets none, as the JAX
package does; ``apply`` and the detect head raise where they must draw.

``get_packed_forward`` is a TPU layout device and is not ported. ``remat``
is a training memory knob and changes nothing at inference.
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
from ..utils.profiling import annotate
from .blocks import SqueezeConv
from .m1_net import M1CascadedNet, M1Net, decision_fusion


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


def _m1_kwargs(num_classes: int = 2,
               dropout_mode: str = "standard", dropout_rate: float = 0.50,
       filters=(32, 64, 128, 256, 512),
       strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (1, 2, 2)),
       kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
       se_reduction=(8, 8, 8, 8, 8),
       att_sub_samp=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
       kernel_initializer=None, bias_initializer=None,
       kernel_regularizer=1e-4, bias_regularizer=1e-4,
       dense_skip: bool = False, deep_supervision: bool = False,
       probabilistic: bool = False, prob_latent_dims=(1, 1, 1, 1),
       fused_prob_passes: bool = True, strict_reference_slicing: bool = False,
       act_store: Any = None, dtype: Any = None, **_ignored) -> Dict[str, Any]:
    """``M1Net``'s keyword arguments (all but ``input_channels``) from the
    reference factory's (networks.py:232-392)."""
    conv_cfg = ConvConfig(kernel_init=kernel_initializer or "orthogonal",
                          bias_init=bias_initializer or "truncated_normal",
                          kernel_l2=_resolve_l2(kernel_regularizer),
                          bias_l2=_resolve_l2(bias_regularizer),
                          dtype=_torch_dtype(dtype), act_store=act_store)
    prob_latent_dims = _as_nested_tuple(prob_latent_dims)
    if len(prob_latent_dims) == 3:
        # M1's default has 3 entries (networks.py:53), the core needs 4
        # (res 3,2,1,0); the reference CLI always passes 4. Pad with 0.
        prob_latent_dims = prob_latent_dims + (0,)
    return dict(
        probabilistic=probabilistic, num_classes=num_classes,
        prob_latent_dims=prob_latent_dims, fused_prob_passes=fused_prob_passes,
        strict_reference_slicing=strict_reference_slicing,
        dropout_mode=dropout_mode, dropout_rate=dropout_rate,
        filters=_as_nested_tuple(filters), strides=_as_nested_tuple(strides),
        kernel_sizes=_as_nested_tuple(kernel_sizes),
        se_reduction=_as_nested_tuple(se_reduction),
        att_sub_samp=_as_nested_tuple(att_sub_samp), conv_cfg=conv_cfg,
        dense_skip=dense_skip, deep_supervision=deep_supervision)


class _Method(torch.nn.Module):
    """``net``'s method ``name`` as a module's forward, so that
    ``torch.func.functional_call`` can run it on given parameters."""

    def __init__(self, net: torch.nn.Module, name: str):
        super().__init__()
        self.net, self.name = net, name

    def forward(self, *args, **kwargs):
        return getattr(self.net, self.name)(*args, **kwargs)


def m1(input_channels: int, **kwargs) -> M1Net:
    """Mid-level factory (reference networks.py:232-392): the single-stage
    module, from the reference factory's keyword arguments."""
    return M1Net(input_channels, **_m1_kwargs(**kwargs))


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
        self.opt_state = None   # set by fit
        self._compiled = None   # the recipe compile() records
        self._net_kwargs = dict(
            input_channels=input_channels, num_classes=num_classes,
            dropout_mode=dropout_mode, dropout_rate=dropout_rate,
            filters=filters, strides=strides, kernel_sizes=kernel_sizes,
            se_reduction=se_reduction, att_sub_samp=att_sub_samp,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer,
            kernel_regularizer=kernel_regularizer,
            bias_regularizer=bias_regularizer, dense_skip=dense_skip,
            deep_supervision=deep_supervision, probabilistic=probabilistic,
            prob_latent_dims=prob_latent_dims, fused_prob_passes=fused_prob_passes,
            strict_reference_slicing=strict_reference_slicing,
            act_store=self.config["act_store"], dtype=self.dtype)
        with torch.device(dev):
            self.net = self._build()
        self.net.eval()
        if init_params:
            self.init(seed)
        if summary:
            self.summary()

    def _build(self):
        """The network module: ``M1Net``, or ``M1CascadedNet`` whose fusion is
        the ``cascaded`` string ('identity' for True)."""
        kw = dict(self._net_kwargs)
        channels = kw.pop("input_channels")
        if not self.cascaded:
            return m1(channels, **kw)
        stage = _m1_kwargs(**kw)
        fusion = self.cascaded if isinstance(self.cascaded, str) else "identity"
        return M1CascadedNet(channels, stage.pop("num_classes"), fusion, **stage)

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
    def example_inputs(self, batch_size: int = 1):
        """Zeros of the model's input shape; a pair for a cascade."""
        x = torch.zeros((batch_size, *self.input_spatial_dims, self.input_channels),
                        device=self.device)
        return (x, x) if self.cascaded else x

    def _as_input(self, inputs):
        if isinstance(inputs, (tuple, list)):  # a cascade's (image_1, image_2)
            return tuple(self._as_input(x) for x in inputs)
        if not torch.is_tensor(inputs):
            inputs = torch.from_numpy(np.ascontiguousarray(inputs, np.float32))
        return inputs.to(self.device).contiguous()

    @property
    def stochastic(self) -> bool:
        """Dropout stays on at inference (the CLI default, cli.py:76-77)."""
        return self.config["dropout_mode"] == "monte-carlo"

    def apply(self, params, inputs, train: bool = False, rng=None,
              method: str = "forward"):
        """Forward pass (inference only in this slice: runs without
        autograd), or with ``method="detect"`` the inference head's
        computation. ``params`` None uses the model's own; a state dict runs
        those instead. ``rng`` feeds the dropout sites and latent samples;
        a draw without one raises."""
        x = self._as_input(inputs)
        rng = prng.as_rng(rng, self.device)
        kw = {"rng": rng} if method == "detect" else {"train": train, "rng": rng}
        with torch.no_grad():
            if params is None:
                return getattr(self.net, method)(x, **kw)
            return torch.func.functional_call(
                _Method(self.net, method), {f"net.{k}": v for k, v in params.items()},
                (x,), kw)

    def __call__(self, inputs, train: bool = False, rng=None):
        if rng is None and (self.probabilistic or self.stochastic or train):
            rng = prng.fresh(self.device)
        return self.apply(None, inputs, train=train, rng=rng)

    def get_detect_model(self) -> Callable:
        """Inference head (reference networks.py:196-206, JAX ``m1.py:
        299-321``): ``detect(params, inputs, rng=None)`` returns
        y_softmax[..., :nc]; infer_softmax for a probabilistic model; for a
        cascade the pair of its stages' (stage 1, stage 2)."""

        def detect(params, inputs, rng=None):
            with annotate("m1.forward"):
                return self.apply(params, inputs, rng=rng, method="detect")

        return detect

    decision_fusion = staticmethod(decision_fusion)

    def predict(self, inputs, rng=None):
        if rng is None and (self.probabilistic or self.stochastic):  # as ``__call__``
            rng = prng.fresh(self.device)
        return self.get_detect_model()(None, inputs, rng=rng)

    # ----------------------------------------------------- train surface
    def compile(self, optimizer=None, loss=None, loss_weights=None, **kwargs):
        """Record the training recipe (Keras-compile parity, train_model.py:231)."""
        self._compiled = dict(optimizer=optimizer, loss=loss,
                              loss_weights=loss_weights, **kwargs)
        return self

    def fit(self, *args, **kwargs):
        """``train.trainer.fit`` of this model with the compiled recipe."""
        from ..train.trainer import fit as _fit

        assert self._compiled is not None, "compile() the model before fit()"
        return _fit(self, *args, **kwargs, **self._compiled)

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
            net = self._build()
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
        with torch.no_grad():  # a CPU generator draws meta tensors (shapes only)
            net((x, x) if self.cascaded else x, rng=torch.Generator().manual_seed(0))
        for line in lines[:max_lines]:
            print(line)
        if len(lines) > max_lines:
            print(f"... ({len(lines) - max_lines} more)")
        return lines

    def summary(self):
        n_params = sum(p.numel() for p in self.net.parameters())
        kind = ("Cascaded " if self.cascaded else "") + (
            "Hierarchical Prob. 3D U-Net" if self.probabilistic else "Deterministic 3D U-Net")
        print("-" * 68)
        print(f"{kind} (Type: M1)  —  params: {n_params:,}")
        print(f"Input: {self.input_spatial_dims} x {self.input_channels}ch  "
              f"classes: {self.num_classes}  device: {self.device}")
        print("-" * 68)
