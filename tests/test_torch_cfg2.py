"""cfg2 of the bench (dense skips and deep supervision) in the port against
the JAX package, on the CPU: the trunk's dense stitches, the four-way deep
supervision concat of ``assemble_outputs``, the detect head, checkpoints
both ways, the inference session and ``serve.run`` (window-sized and
sliding-window). The tiny model and tolerances are described in
tests/test_torch_util.py; bf16: mean |softmax diff| <= 1e-2, the bound of
tests/test_torch_m1.py (the two packages round at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import serve as jserve
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu_torch import serve as tserve
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from test_torch_util import (ATOL, SPATIAL, assert_tree_close, inputs, jax_model,
                             port_model, to_np)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

CFG2 = dict(input_channels=3, dense_skip=True, deep_supervision=True)
TRUNK_KEYS = ("x", "conv1", "convm", "att_conv0", "uconv3_", "uconv3", "uconv2_",
              "uconv2", "uconv1_", "uconv1", "uconv0_", "uconv0", "logits")


@pytest.fixture(scope="module")
def jcfg2():
    return jax_model(0, **CFG2)


@pytest.fixture(scope="module")
def batch():
    return inputs(1, 3)


@pytest.fixture(scope="module")
def jax_out(jcfg2, batch):
    return to_np(dict(jcfg2.apply(jcfg2.params, batch)))


def test_trunk_with_dense_skip_matches_jax(jcfg2, batch):
    want = jcfg2.net.apply({"params": jcfg2.params}, batch,
                           method=lambda m, x: m.core.trunk(x, False))
    got = port_model(jcfg2).net.core.trunk(torch.from_numpy(batch))
    # the stitches are part lists: 2, 3, 4 and 5 parts at stages 3..0
    assert [len(got[f"uconv{i}_"]) for i in (3, 2, 1, 0)] == [2, 3, 4, 5]
    assert_tree_close({k: got[k] for k in TRUNK_KEYS}, {k: want[k] for k in TRUNK_KEYS})


def test_assemble_outputs_with_deep_supervision_matches_jax(jcfg2, batch, jax_out):
    got = port_model(jcfg2)(batch)
    assert got["y_softmax"].shape == (2, *SPATIAL, 8)  # logits + three heads
    assert_tree_close({k: got[k] for k in ("y_softmax", "y_sigmoid", "logits")},
                      {k: jax_out[k] for k in ("y_softmax", "y_sigmoid", "logits")})


def test_detect_is_the_first_softmax_group(jcfg2, batch, jax_out):
    """The head returns y_softmax[..., :nc] and runs no deep-supervision
    head; its output equals the full forward's first softmax group."""
    model = port_model(jcfg2)
    got = model.predict(batch)
    np.testing.assert_allclose(got.numpy(), jax_out["y_softmax"][..., :2], atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), model(batch)["y_softmax"][..., :2].numpy())
    calls = []
    hook = model.net.core.dsy1_logits.register_forward_hook(lambda *a: calls.append(1))
    model.predict(batch)
    hook.remove()
    assert calls == []


@pytest.mark.parametrize("dense_skip,deep_supervision", [(True, False), (False, True)])
def test_submodules_exist_where_flax_makes_params(dense_skip, deep_supervision, batch):
    jm = jax_model(2, input_channels=3, dense_skip=dense_skip,
                   deep_supervision=deep_supervision)
    model = port_model(jm)
    assert set(model.params) == set(from_jax_params(jm.params))
    want = to_np(dict(jm.apply(jm.params, batch)))
    assert_tree_close({k: model(batch)[k] for k in ("y_softmax", "logits")},
                      {k: want[k] for k in ("y_softmax", "logits")})


def test_jax_cfg2_checkpoint_loads_with_every_leaf_matched(jcfg2, batch, jax_out, tmp_path):
    path = str(tmp_path / "cfg2.npz")
    jcfg2.save(path)
    model = TM1.load(path, device="cpu")
    assert model.config == jcfg2.config
    flat = from_jax_params(jcfg2.params)
    assert set(model.params) == set(flat)
    model.load_weights(path, strict=True)
    np.testing.assert_allclose(model(batch)["y_softmax"].numpy(), jax_out["y_softmax"],
                               atol=ATOL)


def test_port_cfg2_checkpoint_loads_in_jax(jcfg2, batch, jax_out, tmp_path):
    path = str(tmp_path / "port.npz")
    port_model(jcfg2).save(path)
    back = JM1.load(path)
    np.testing.assert_allclose(np.asarray(back.apply(back.params, batch)["y_softmax"]),
                               jax_out["y_softmax"], atol=ATOL)


def test_bf16_cfg2_stays_near_jax_bf16(jcfg2, batch, tmp_path):
    """bf16 compute on both sides; mean |diff| <= 1e-2 (module docstring)."""
    path = str(tmp_path / "cfg2.npz")
    jcfg2.save(path)
    want = np.asarray(JM1.load(path, dtype=jnp.bfloat16).predict(batch), np.float32)
    got = TM1.load(path, device="cpu", dtype=torch.bfloat16).predict(batch)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.mean() <= 1e-2 and diff.max() <= 0.25, (diff.mean(), diff.max())


@pytest.mark.parametrize("tta", [False, True])
def test_inference_session_matches_jax(jcfg2, batch, tta):
    want, _ = jserve.InferenceSession(jcfg2, tta=tta)(batch)
    got, unc = tserve.InferenceSession(port_model(jcfg2), tta=tta, device="cpu")(batch)
    assert unc is None and got.shape == want.shape == (2, *SPATIAL, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _manifest(tmp_path, shapes):
    rng = np.random.default_rng(5)
    lines = ["p-id,image_path"]
    for i, shape in enumerate(shapes):
        path = str(tmp_path / f"case{i}.npy")
        np.save(path, rng.normal(size=(*shape, 3)).astype(np.float32))
        lines.append(f"case{i},{path}")
    man = str(tmp_path / "m.csv")
    with open(man, "w") as f:
        f.write("\n".join(lines) + "\n")
    return man


def test_serve_run_matches_jax(jcfg2, tmp_path):
    """Two window-sized cases and one whole-gland case (8 tiles)."""
    ckpt = str(tmp_path / "cfg2.npz")
    jcfg2.save(ckpt)
    man = _manifest(tmp_path, [SPATIAL, SPATIAL, (6, 24, 24)])
    argv = ["--MODEL", ckpt, "--MANIFEST", man, "--BATCH_SIZE", "2"]
    want = jserve.run(jserve.build_parser().parse_args(argv + ["--OUTPUT_DIR",
                                                               str(tmp_path / "j")]))
    got = tserve.run(tserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "t"), "--DEVICE", "cpu"]))
    assert [r["p-id"] for r in got] == [r["p-id"] for r in want] == ["case0", "case1", "case2"]
    for g, w in zip(got, want):
        a, b = np.load(g["detection_path"]), np.load(w["detection_path"])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)
        assert abs(g["case_score"] - w["case_score"]) <= ATOL
