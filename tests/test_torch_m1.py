"""The port's deterministic M1 path against the JAX package's, end to end on
the CPU: bridged parameters, both checkpoint directions, the inference
session and the serve CLI.

The model is the verify skill's tiny one (filters 4/8/12/16/24, SE reduction
2, 3 channels, the bench cfg1 strides) on a 4x16x16 volume, built once per
module; its flax parameters are redrawn by numpy so every weight differs
from its initializer's constant. fp32 tolerance: atol 2e-5, the repo's
oracle tolerance (tests/test_tf_parity.py:43).
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import serve as jserve
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu_torch import serve as tserve
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5
SPATIAL = (4, 16, 16)
KW = dict(input_spatial_dims=SPATIAL, input_channels=3, num_classes=2,
          filters=(4, 8, 12, 16, 24),
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
          se_reduction=(2, 2, 2, 2, 2), summary=False)


def _redraw(params, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return jnp.asarray(rng.normal(0, fan_in ** -0.5, shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(1 + 0.3 * rng.normal(size=shape), jnp.float32)
        return jnp.asarray(0.3 * rng.normal(size=shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def jax_model():
    model = JM1(**KW)  # dropout 0.5 'standard': the identity at inference
    model.params = _redraw(model.params, 0)
    return model


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(1)
    return [rng.normal(size=(2, *SPATIAL, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_out(jax_model, requests):
    out = jax_model.apply(jax_model.params, requests[0])
    return {k: np.asarray(v) for k, v in out.items()}


def _port(jax_model, **kw):
    model = TM1(**KW, device="cpu", init_params=False, **kw)
    model.params = from_jax_params(jax_model.params)
    return model


def _check_outputs(got, want):
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"], atol=ATOL)
    np.testing.assert_allclose(got["y_softmax"].numpy(), want["y_softmax"], atol=ATOL)
    # argmax agrees wherever the two logits are not within the tolerance
    margin = np.abs(want["logits"][..., 1] - want["logits"][..., 0])
    decided = margin > 4 * ATOL
    np.testing.assert_array_equal(got["y_"].numpy()[decided], want["y_"][decided])


def test_bridged_params_match_jax(jax_model, requests, jax_out):
    got = _port(jax_model)(requests[0])
    assert set(got) == {"y_softmax", "y_sigmoid", "logits", "y_"}
    _check_outputs(got, jax_out)
    np.testing.assert_allclose(got["y_sigmoid"].numpy(), jax_out["y_sigmoid"],
                               atol=ATOL)


def test_apply_runs_a_given_state_dict(jax_model, requests, jax_out):
    """``apply(params, x)`` runs the given parameters, not the model's own."""
    model = TM1(**KW, device="cpu", seed=5)
    own = model(requests[0])["logits"]
    got = model.apply(from_jax_params(jax_model.params), requests[0])
    _check_outputs(got, jax_out)
    assert torch.equal(model(requests[0])["logits"], own)


def test_jax_checkpoint_loads_in_port(jax_model, requests, jax_out, tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_model.save(path)
    model = TM1.load(path, device="cpu")
    assert model.config == jax_model.config
    _check_outputs(model(requests[0]), jax_out)
    np.testing.assert_allclose(model.predict(requests[0]).numpy(),
                               jax_out["y_softmax"][..., :2], atol=ATOL)


def test_port_checkpoint_loads_in_jax(jax_model, requests, jax_out, tmp_path):
    path = str(tmp_path / "port.npz")
    _port(jax_model).save(path)
    back = JM1.load(path)
    out = back.apply(back.params, requests[0])
    _check_outputs({k: torch.from_numpy(np.array(v)) for k, v in out.items()},
                   jax_out)


def test_bf16_load_override_stays_near_jax_bf16(jax_model, requests, tmp_path):
    """bf16 compute on both sides: the two round at different places (the
    port's kernels accumulate and add bias in fp32 and round once), so the
    softmax is held to a bf16-scale bound, mean |diff| <= 1e-2."""
    path = str(tmp_path / "jax.npz")
    jax_model.save(path)
    want = np.asarray(JM1.load(path, dtype=jnp.bfloat16).predict(requests[0]),
                      np.float32)
    got = TM1.load(path, device="cpu", dtype=torch.bfloat16).predict(requests[0])
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.mean() <= 1e-2 and diff.max() <= 0.25, (diff.mean(), diff.max())


@pytest.mark.parametrize("channels", ["all", "foreground"])
def test_inference_session_matches_jax(jax_model, requests, channels):
    jsess = jserve.InferenceSession(jax_model, transfer_channels=channels)
    tsess = tserve.InferenceSession(_port(jax_model), device="cpu",
                                    transfer_channels=channels)
    for batch in requests:
        want, want_unc = jsess(batch)
        got, got_unc = tsess(batch)
        assert got_unc is None and want_unc is None
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)


def _manifest(tmp_path, n):
    rng = np.random.default_rng(2)
    rows = []
    for i in range(n):
        ip = str(tmp_path / f"case{i}.npy")
        np.save(ip, rng.normal(size=(*SPATIAL, 3)).astype(np.float32))
        rows.append({"p-id": f"case{i}", "image_path": ip})
    man = str(tmp_path / "test.csv")
    with open(man, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        [w.writerow(r) for r in rows]
    return man


def test_serve_run_matches_jax(jax_model, tmp_path):
    ckpt = str(tmp_path / "model.npz")
    jax_model.save(ckpt)
    man = _manifest(tmp_path, 2)
    argv = ["--MODEL", ckpt, "--MANIFEST", man, "--BATCH_SIZE", "2"]
    want = jserve.run(jserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "jax")]))
    got = tserve.run(tserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "port"), "--DEVICE", "cpu"]))
    with open(tmp_path / "port" / "predictions.json") as f:
        assert json.load(f) == got
    assert [r["p-id"] for r in got] == [r["p-id"] for r in want] == ["case0", "case1"]
    assert all(r["lesion_candidates"] for r in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.load(g["detection_path"]),
                                   np.load(w["detection_path"]), atol=ATOL)
        assert os.path.basename(g["detection_path"]) == f"{g['p-id']}_detection.npy"
        assert abs(g["case_score"] - w["case_score"]) <= ATOL
        assert [c["voxels"] for c in g["lesion_candidates"]] == \
            [c["voxels"] for c in w["lesion_candidates"]]
        np.testing.assert_allclose([c["score"] for c in g["lesion_candidates"]],
                                   [c["score"] for c in w["lesion_candidates"]],
                                   atol=ATOL)


def test_serve_refuses_what_waits_for_later_slices(jax_model, tmp_path):
    """Sliding windows, --MC_ITER, --TTA, --SCAN_CHUNK and fold ensembles
    serve now (a second exam too: tests/test_torch_cascade.py), and so do
    .zip artifacts (tests/test_torch_export_serve.py; a missing one is not
    found); --DATA_PARALLEL 2 serves on two CPU positions the one-device
    outputs (tests/test_torch_parallel_serve.py holds it against JAX)."""
    ckpt = str(tmp_path / "model.npz")
    jax_model.save(ckpt)
    rng = np.random.default_rng(3)
    big = str(tmp_path / "big.npy")
    np.save(big, rng.normal(size=(6, 24, 24, 3)).astype(np.float32))
    man = str(tmp_path / "big.csv")
    with open(man, "w") as fh:
        fh.write(f"p-id,image_path\nbig,{big}\n")
    base = ["--MODEL", ckpt, "--OUTPUT_DIR", str(tmp_path / "o"), "--DEVICE", "cpu"]
    got = tserve.main(base + ["--MANIFEST", man])
    assert np.load(got[0]["detection_path"]).shape == (6, 24, 24, 2)
    small = _manifest(tmp_path, 3)
    for extra in (["--MC_ITER", "2"], ["--TTA", "1"], ["--SCAN_CHUNK", "2"],
                  ["--MODEL", f"{ckpt},{ckpt}"]):
        out = tserve.main(base + ["--MANIFEST", small] + extra)
        assert [r["p-id"] for r in out] == ["case0", "case1", "case2"]
    dp = tserve.main(base[:3] + [str(tmp_path / "dp"), "--DEVICE", "cpu", "--MANIFEST", small,
                                 "--DATA_PARALLEL", "2"])
    for a, b in zip(dp, out):
        assert a["p-id"] == b["p-id"]
        np.testing.assert_allclose(np.load(a["detection_path"]), np.load(b["detection_path"]),
                                   atol=ATOL)
    with pytest.raises(FileNotFoundError, match="artifact.zip"):
        tserve.main(base + ["--MANIFEST", small, "--MODEL", str(tmp_path / "artifact.zip")])


def test_jax_mc_dropout_checkpoint_loads_with_every_leaf_matched(tmp_path):
    """A checkpoint of the training CLI's default dropout (monte-carlo, 0.5)
    saved by the JAX package loads into the port: dropout has no
    parameters, and every leaf maps onto one of the port's, unchanged."""
    jmc = JM1(**KW, dropout_mode="monte-carlo", dropout_rate=0.5)
    jmc.params = _redraw(jmc.params, 4)
    path = str(tmp_path / "mc.npz")
    jmc.save(path)
    model = TM1.load(path, device="cpu")
    assert model.config["dropout_mode"] == "monte-carlo"
    assert model.config["dropout_rate"] == 0.5 and model.stochastic
    flat = from_jax_params(jmc.params)
    assert set(model.params) == set(flat)
    for key, leaf in flat.items():
        assert torch.equal(model.params[key], leaf), key
    model.load_weights(path, strict=True)  # nothing unmatched either way


def test_init_draws_the_reference_initializers():
    a = TM1(**KW, device="cpu", seed=3)
    b = TM1(**KW, device="cpu", seed=3)
    for (name, pa), pb in zip(a.params.items(), b.params.values()):
        assert torch.equal(pa, pb), name
    k = a.params["core.serse2.conv1.kernel"]
    m = k.reshape(-1, k.shape[-1]).double()  # orthogonal columns
    np.testing.assert_allclose((m.T @ m).numpy(), np.eye(k.shape[-1]), atol=1e-5)
    bias = a.params["core.serse2.conv1.bias"]
    assert 0 < bias.abs().max() <= 2 * 0.001 / 0.8796 + 1e-7  # +-2 sigma
    assert torch.equal(a.params["core.serse2.norm1.scale"], torch.ones(3))
    assert torch.equal(a.params["core.serse2.se_conv6.bias"], torch.zeros(6))


def test_load_weights_keeps_unmatched_leaves(jax_model, tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_model.save(path)
    kw = dict(KW, num_classes=3)
    model = TM1(**kw, device="cpu", seed=0)
    head = model.params["core.logits.kernel"].clone()
    model.load_weights(path)
    assert torch.equal(model.params["core.logits.kernel"], head)
    np.testing.assert_array_equal(
        model.params["core.conve0.kernel"].numpy(),
        np.asarray(jax_model.params["core"]["conve0"]["kernel"]))
    with pytest.raises(ValueError, match="strict"):
        model.load_weights(path, strict=True)


def test_describe_lists_every_stage():
    lines = TM1(**KW, device="cpu").describe(max_lines=0)
    names = [ln.split()[0] for ln in lines]
    assert "core/logits" in names and "core/att0/norm_out" in names
    assert [ln for ln in lines if ln.startswith("core/logits ")][0].endswith(
        str((1, *SPATIAL, 2)))
