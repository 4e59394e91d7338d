"""Import the reference's TF/Keras M1 weights into the port, port of the JAX
package's ``utils/tf_import.py`` (its numpy code, copied: the port imports
nothing of the JAX package).

The reference ships Keras H5 checkpoints (modelio.py:98-117). This module
maps a Keras deterministic-M1 layer graph (stem -> SE encoder -> attention
gates -> nested decoder -> logits, the reference build order
networks.py:472-526) onto the port's parameters:

  * Conv3D            kernel (k,k,k,in,out), bias  -> Conv3d
  * Conv3DTranspose   kernel (k,k,k,out,in), bias  -> ConvTranspose3d (the
                      TF convention, the port's layout as well)
  * InstanceNorm      gamma/beta                   -> scale/bias

Every function works on the port's '/'-flat parameter dict
(``bridge.to_jax_params(model.net)``: ``core/serse1/conv1/kernel`` ...) and
returns a new one, which ``bridge.from_jax_params`` turns into the model's
state dict. ``h5py`` is imported only where an H5 file is read.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def flax_weight_order(dense_skip: bool = False) -> List[Tuple[str, str]]:
    """Ordered (path, kind) list of the deterministic M1 core in the
    reference's layer creation order. kind: conv | convT | norm."""

    def se(name):
        return [
            (f"{name}/conv1", "conv"), (f"{name}/norm1", "norm"),
            (f"{name}/conv2", "conv"), (f"{name}/norm2", "norm"),
            (f"{name}/conv3", "conv"), (f"{name}/norm3", "norm"),
            (f"{name}/conv4", "conv"), (f"{name}/norm4", "norm"),
            (f"{name}/se_conv6", "conv"), (f"{name}/se_conv7", "conv"),
        ]

    def att(name):
        return [
            (f"{name}/theta", "conv"), (f"{name}/phi", "conv"),
            (f"{name}/psi", "conv"), (f"{name}/out", "conv"),
            (f"{name}/norm_out", "norm"),
        ]

    order: List[Tuple[str, str]] = [("conve0", "conv"), ("norme0", "norm")]
    for i in (1, 2, 3, 4):
        order += se(f"serse{i}")
    for i in (0, 1, 2, 3):
        order += att(f"att{i}")
    order += [("convtd3", "convT")]
    if dense_skip:
        order += [("convtd3_up1", "convT"), ("convtd3_up2", "convT"),
                  ("convtd3_up3", "convT")]
    order += se("sersd3")
    order += [("convtd2", "convT")]
    if dense_skip:
        order += [("convtd2_up1", "convT"), ("convtd2_up2", "convT")]
    order += se("sersd2")
    order += [("convtd1", "convT")]
    if dense_skip:
        order += [("convtd1_up1", "convT")]
    order += se("sersd1")
    order += [("convtd0", "convT")]
    order += se("sersd0")
    order += [("logits", "conv")]
    return order


def flax_prob_core_order(prob_latent_dims: Sequence[int], deep_supervision: bool = False,
                         dense_skip: bool = False) -> List[Tuple[str, str]]:
    """(path, kind) list of a PROBABILISTIC M1Core: the deterministic trunk,
    the deep-supervision heads (when enabled) and the latent ladder
    (mu_logsig_i / dec_hi_i / sersp_i per level, reference
    networks.py:534-565)."""
    order = list(flax_weight_order(dense_skip))
    if deep_supervision:
        order += [(f"dsy{i}_logits", "conv") for i in (1, 2, 3)]
    for i, dim in enumerate(prob_latent_dims):
        if dim != 0:
            order += [(f"mu_logsig_{i}", "conv")]
        order += [(f"dec_hi_{i}", "convT")]
        order += [
            (f"sersp_{i}/conv1", "conv"), (f"sersp_{i}/norm1", "norm"),
            (f"sersp_{i}/conv2", "conv"), (f"sersp_{i}/norm2", "norm"),
            (f"sersp_{i}/conv3", "conv"), (f"sersp_{i}/norm3", "norm"),
            (f"sersp_{i}/conv4", "conv"), (f"sersp_{i}/norm4", "norm"),
            (f"sersp_{i}/se_conv6", "conv"), (f"sersp_{i}/se_conv7", "conv"),
        ]
    return order


def _assign(params: Dict[str, np.ndarray], root: str, path: str, kind: str,
            ws: Sequence[np.ndarray], src: str) -> None:
    """Keras weights ``ws`` of layer ``src`` into ``params`` at ``root/path``,
    shape-checked."""
    base = f"{root}/{path}"
    names = ("kernel", "bias") if kind in ("conv", "convT") else ("scale", "bias")
    for name, w in zip(names, ws):
        key = f"{base}/{name}"
        if key not in params:
            raise ValueError(f"{src} -> {path}: the model has no {key!r}")
        w = np.asarray(w)
        if tuple(params[key].shape) != tuple(w.shape):
            raise ValueError(f"{src} -> {path}: {name} shape {w.shape} != "
                             f"{tuple(params[key].shape)}")
        params[key] = w.astype(params[key].dtype)


def import_keras_m1_prob_weights(keras_layers, params: Dict[str, np.ndarray],
                                 prob_latent_dims: Sequence[int],
                                 deep_supervision: bool = False,
                                 dense_skip: bool = False) -> Dict[str, np.ndarray]:
    """Name-based import for the probabilistic M1Net: Keras layers named
    'prior.<path>' / 'posterior.<path>' / 'final_decoder.logits' -> the
    parameters under 'prior' / 'posterior' / 'final_decoder'. Shape-checked
    per leaf; a missing or an unmatched layer raises."""
    out = dict(params)
    by_name = {layer.name: layer for layer in keras_layers if layer.weights}
    for root, ds in (("prior", deep_supervision), ("posterior", False)):
        for path, kind in flax_prob_core_order(prob_latent_dims, deep_supervision=ds,
                                               dense_skip=dense_skip):
            lname = f"{root}." + path.replace("/", ".")
            layer = by_name.pop(lname, None)
            if layer is None:
                raise ValueError(f"the Keras model lacks layer {lname!r}")
            _assign(out, root, path, kind, [np.asarray(w) for w in layer.get_weights()],
                    src=lname)
    layer = by_name.pop("final_decoder.logits", None)
    if layer is None:
        raise ValueError("the Keras model lacks final_decoder.logits")
    _assign(out, "final_decoder", "logits", "conv",
            [np.asarray(w) for w in layer.get_weights()], src="final_decoder.logits")
    if by_name:
        raise ValueError(f"unmapped Keras layers: {sorted(by_name)}")
    return out


def import_keras_m1_weights(keras_layers, params: Dict[str, np.ndarray],
                            root: str = "core",
                            dense_skip: bool = False) -> Dict[str, np.ndarray]:
    """Weights of a Keras layer list, matched by layer NAME: each weighted
    Keras layer is named with its parameter path joined by '.' (e.g.
    ``serse1.conv1``, ``att0.norm_out``). Returns a NEW dict; every expected
    path must be present on both sides (the architectures must agree)."""
    out = dict(params)
    by_name = {layer.name: layer for layer in keras_layers if layer.weights}
    order = flax_weight_order(dense_skip)
    missing = [p for p, _ in order if p.replace("/", ".") not in by_name]
    if missing:
        raise ValueError(f"the Keras model lacks named layers for: {missing}")
    extra = set(by_name) - {p.replace("/", ".") for p, _ in order}
    if extra:
        raise ValueError(f"unmapped Keras layers: {sorted(extra)}")
    for path, kind in order:
        name = path.replace("/", ".")
        _assign(out, root, path, kind,
                [np.asarray(w) for w in by_name[name].get_weights()], src=name)
    return out


# Build-order import: the reference's H5 checkpoints AS SHIPPED (Keras
# default layer names: modelio.py:98-117 never renames layers).

def _kind_of_layer_name(name: str):
    """A Keras layer's kind from its default name: Conv3D 'conv3d[_N]',
    Conv3DTranspose 'conv3d_transpose[_N]', tfa's instance or group
    normalization '*normalization[_N]'; weightless layers give None."""
    n = name.lower()
    if "transpose" in n:
        return "convT"
    if "normalization" in n:
        return "norm"
    if "conv" in n:
        return "conv"
    return None


def _creation_index(name: str) -> int:
    """The per-class creation counter of a Keras auto-name: the first
    instance is bare ('conv3d', -1), later ones suffixed ('conv3d_7', 7).
    Sorting by it recovers the CREATION order even where the layer list (or
    the H5 'layer_names' attr) is stored topologically."""
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else -1


def import_keras_m1_weights_by_order(
    named_weights: Sequence[Tuple[str, Sequence[np.ndarray]]],
    params: Dict[str, np.ndarray], root: str = "core", dense_skip: bool = False,
) -> Dict[str, np.ndarray]:
    """Weights matched by per-class CREATION order, so the reference's
    checkpoints load as shipped, with no renamed layers.

    ``named_weights``: [(keras_layer_name, [weight arrays])] of every weighted
    layer, in any order. Each class (Conv3D, Conv3DTranspose,
    normalization) is sorted by the Keras auto-name counter and zipped with
    :func:`flax_weight_order`'s same-kind subsequence: the reference builds
    its graph in call order (networks.py:472-526), so the k-th Conv3D
    created is the k-th conv of that order. Every assignment is
    shape-checked; a mismatch raises with both names.
    """
    out = dict(params)
    want: Dict[str, List[str]] = {"conv": [], "convT": [], "norm": []}
    for path, kind in flax_weight_order(dense_skip):
        want[kind].append(path)
    have: Dict[str, List[Tuple[int, str, List[np.ndarray]]]] = {
        "conv": [], "convT": [], "norm": []}
    for name, ws in named_weights:
        kind = _kind_of_layer_name(name)
        if kind is None:
            raise ValueError(f"cannot classify weighted Keras layer {name!r}")
        have[kind].append((_creation_index(name), name, list(ws)))
    for kind in have:
        have[kind].sort(key=lambda t: t[0])
        if len(have[kind]) != len(want[kind]):
            raise ValueError(
                f"{kind}: checkpoint has {len(have[kind])} layers, architecture "
                f"expects {len(want[kind])} ({[n for _, n, _ in have[kind]]} vs "
                f"{want[kind]})")
    for kind in ("conv", "convT", "norm"):
        for path, (_, name, ws) in zip(want[kind], have[kind]):
            _assign(out, root, path, kind, ws, src=name)
    return out


def read_legacy_h5_weights(path: str) -> List[Tuple[str, List[np.ndarray]]]:
    """Read a TF2.x topological ``save_weights`` H5 (what the reference's
    modelio.py:90-96 writes): root (or ``model_weights``) attr
    'layer_names', per-layer group attr 'weight_names', datasets at
    ``<layer>/<weight_name>``. Returns [(layer_name, [arrays])] of every
    layer that carries weights, in stored order."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError("reading a Keras H5 checkpoint needs the h5py package, "
                          "which is not installed") from err

    def _s(v):
        return v.decode() if isinstance(v, bytes) else str(v)

    out: List[Tuple[str, List[np.ndarray]]] = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        for ln in [_s(n) for n in g.attrs["layer_names"]]:
            lg = g[ln]
            wnames = [_s(n) for n in lg.attrs.get("weight_names", [])]
            if wnames:
                out.append((ln, [np.asarray(lg[w]) for w in wnames]))
    return out


def import_reference_h5(h5_path: str, params: Dict[str, np.ndarray], root: str = "core",
                        dense_skip: bool = False) -> Dict[str, np.ndarray]:
    """One-call import of a reference-saved H5 checkpoint (Keras default
    names, TF2.5 topological format) into the '/'-flat ``params``. No TF
    needed: the H5 is read directly (h5py)."""
    return import_keras_m1_weights_by_order(read_legacy_h5_weights(h5_path), params,
                                            root=root, dense_skip=dense_skip)
