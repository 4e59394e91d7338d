"""The port's tools against the JAX package's, on the CPU: FLOP counting
(``utils/flops.py``: the port's exported graph against JAX's jaxpr walk,
equal counts) and the reference H5 importer (``utils/tf_import.py``: a
synthetic checkpoint in the TF2.5 ``save_weights`` layout, written here with
h5py under Keras' default layer names, imported by both packages: equal
arrays, and forwards within atol 2e-5).
"""

import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu.utils import flops as jflops
from prostatemr_3d_cad_cspca_tpu.utils import tf_import as jtf
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params, to_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.utils import flops as tflops
from prostatemr_3d_cad_cspca_tpu_torch.utils import tf_import as ttf
from prostatemr_3d_cad_cspca_tpu_torch.utils.serialization import flatten
from test_torch_util import ATOL, inputs, jax_model, port_model, to_np
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)


# ------------------------------------------------------------------- flops
@pytest.mark.parametrize("kind", ["deterministic", "cascade"])
def test_count_matmul_flops_of_the_detect_head_equals_jax(kind):
    kw = dict(cascaded="noisy-or") if kind == "cascade" else {}
    jm = jax_model(0, input_channels=3, **kw)
    pm = port_model(jm)
    x = inputs(0, 3)
    jdet, pdet = jm.get_detect_model(), pm.get_detect_model()
    xt = torch.from_numpy(x)
    if kind == "cascade":
        want = jflops.count_matmul_flops(lambda a, b: jdet(jm.params, (a, b)), x, x)
        got = tflops.count_matmul_flops(lambda a, b: pdet(None, (a, b)), xt, xt)
    else:
        want = jflops.count_matmul_flops(lambda a: jdet(jm.params, a), x)
        got = tflops.count_matmul_flops(lambda a: pdet(None, a), xt)
    assert got == want and got > 0


def test_count_matmul_flops_counts_convs_matmuls_and_operators():
    x = torch.randn(2, 5, 6, 7, 3)
    w = torch.randn(3, 3, 3, 3, 8)
    wt = torch.randn(2, 2, 2, 4, 8)  # (kd, kh, kw, Cout, Cin)
    a, b = torch.randn(4, 6), torch.randn(6, 5)

    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    def fn(x):
        y = cv.conv3d([x], w, None, (1, 1, 1))         # 2 * 2*5*6*7*8 * 3 * 27
        z = cv.conv3d_transpose(y, wt, None, (2, 2, 2))  # 2 * 2*10*12*14*4 * 8 * 8
        return z, a @ b                                   # 2 * 4*5 * 6

    want = 2 * (2 * 5 * 6 * 7 * 8 * 3 * 27 + 2 * 10 * 12 * 14 * 4 * 8 * 8 + 4 * 5 * 6)
    assert tflops.count_matmul_flops(fn, x) == want
    arrays = [np.zeros((3, 4), np.float32), np.zeros(5, np.float16)]
    assert tflops.logical_io_bytes(*arrays) == jflops.logical_io_bytes(*arrays) == 58
    assert tflops.logical_io_bytes(torch.zeros(3, 4, dtype=torch.bfloat16)) == 24


# --------------------------------------------------------------- H5 import
def _keras_layers(jmodel, seed):
    """The reference's weighted layers in creation order under Keras'
    default names (conv3d, conv3d_1, ..., conv3d_transpose_N,
    instance_normalization_N), each with numpy-drawn weights of the JAX
    model's shapes: [(name, [(weight name, array)])]."""
    rng = np.random.default_rng(seed)
    core = jmodel.params["core"]
    counters, layers = {}, []
    names = {"conv": "conv3d", "convT": "conv3d_transpose", "norm": "instance_normalization"}
    for path, kind in jtf.flax_weight_order():
        node = core
        for p in path.split("/"):
            node = node[p]
        base = names[kind]
        n = counters.get(base, 0)
        counters[base] = n + 1
        lname = base if n == 0 else f"{base}_{n}"
        leaves = ("kernel", "bias") if kind != "norm" else ("scale", "bias")
        tf_names = ("kernel", "bias") if kind != "norm" else ("gamma", "beta")
        ws = []
        for leaf, tf_name in zip(leaves, tf_names):
            shape = node[leaf].shape
            scale = 1.0 / np.sqrt(np.prod(shape[:-1])) if leaf == "kernel" else 0.3
            val = (1.0 if leaf == "scale" else 0.0) + scale * rng.normal(size=shape)
            ws.append((f"{lname}/{tf_name}:0", val.astype(np.float32)))
        layers.append((lname, ws))
    return layers


def _write_legacy_h5(path, layers, order):
    """The TF2.x topological ``save_weights`` layout: root attr
    'layer_names' (here in ``order``, not creation order), a group a layer
    with attr 'weight_names' and its datasets, plus one weightless layer."""
    with h5py.File(path, "w") as f:
        names = [layers[i][0] for i in order] + ["leaky_re_lu"]
        f.attrs["layer_names"] = [n.encode() for n in names]
        f.attrs["backend"] = b"tensorflow"
        for lname, ws in layers:
            g = f.create_group(lname)
            g.attrs["weight_names"] = [w.encode() for w, _ in ws]
            for wname, val in ws:
                g.create_dataset(wname, data=val)
        f.create_group("leaky_re_lu").attrs["weight_names"] = []


def test_import_reference_h5_equals_jax(tmp_path):
    jm = jax_model(0, input_channels=3)
    pm = port_model(jm)
    layers = _keras_layers(jm, seed=7)
    order = np.random.default_rng(3).permutation(len(layers))  # stored topologically
    path = str(tmp_path / "reference_checkpoint.h5")
    _write_legacy_h5(path, layers, order)

    read_j, read_t = jtf.read_legacy_h5_weights(path), ttf.read_legacy_h5_weights(path)
    assert [n for n, _ in read_t] == [n for n, _ in read_j] == [layers[i][0] for i in order]
    jparams = jtf.import_reference_h5(path, jm.params)
    want = flatten(jparams)
    got = ttf.import_reference_h5(path, to_jax_params(pm.net))
    assert set(got) == set(want)
    for k in want:  # array for array, the same bits
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    pm.params = from_jax_params(got)
    x = inputs(5, 3)
    jout = np.asarray(jm.apply(jparams, jnp.asarray(x))["y_softmax"])
    with torch.no_grad():
        pout = pm.net(torch.from_numpy(x))["y_softmax"]
    np.testing.assert_allclose(to_np(pout), jout, atol=ATOL)


def test_import_by_order_refuses_a_count_mismatch(tmp_path):
    jm = jax_model(0, input_channels=3)
    pm = port_model(jm)
    named = [(name, [v for _, v in ws]) for name, ws in _keras_layers(jm, seed=7)]
    flat = to_jax_params(pm.net)
    with pytest.raises(ValueError, match="architecture expects"):
        ttf.import_keras_m1_weights_by_order(named[:-1], flat)
    with pytest.raises(ValueError, match="architecture expects"):
        jtf.import_keras_m1_weights_by_order(named[:-1], jm.params)
    bad = list(named)
    bad[0] = (bad[0][0], [np.zeros((1, 1, 1, 3, 4), np.float32), bad[0][1][1]])
    with pytest.raises(ValueError, match="kernel shape"):
        ttf.import_keras_m1_weights_by_order(bad, flat)
    with pytest.raises(ValueError, match="classify"):
        ttf.import_keras_m1_weights_by_order([("dense", [])] + named, flat)


def test_name_based_import_equals_jax():
    class Layer:
        def __init__(self, name, ws):
            self.name, self._ws = name, ws
            self.weights = ws

        def get_weights(self):
            return self._ws

    jm = jax_model(0, input_channels=3)
    pm = port_model(jm)
    layers = _keras_layers(jm, seed=11)
    by_path = [Layer(path.replace("/", "."), [v for _, v in ws])
               for (path, _), (_, ws) in zip(jtf.flax_weight_order(), layers)]
    want = flatten(jtf.import_keras_m1_weights(by_path, jm.params))
    got = ttf.import_keras_m1_weights(by_path, to_jax_params(pm.net))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="lacks named layers"):
        ttf.import_keras_m1_weights(by_path[1:], to_jax_params(pm.net))
    assert ttf.flax_prob_core_order((2, 1, 0), True) == jtf.flax_prob_core_order((2, 1, 0), True)
    assert ttf.flax_weight_order(True) == jtf.flax_weight_order(True)


def test_reading_h5_without_h5py_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs the h5py package"):
        ttf.read_legacy_h5_weights(str(tmp_path / "x.h5"))
