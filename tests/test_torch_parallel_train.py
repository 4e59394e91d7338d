"""The port's train step on a mesh against the JAX package's, on the CPU:
the data-parallel step at world 2 and 4 (spawned gloo ranks,
tests/test_torch_dist_util.py) against JAX's ``make_train_step(mesh=)`` on
2 and 4 of its forced host devices, for the focal and the region/boundary
loss, the Monte-Carlo model with JAX's keep-masks replayed (each rank its
rows) and the CLI's augmentation with JAX's draws replayed;
``scan_steps``/``accum_steps`` and ``fit`` on a mesh against the
one-process port; and the tensor-parallel step at data 2 x model 2 against
the data-parallel loss (rtol 1e-4, as JAX's test) with JAX's
``param_partition_spec``.

The model is tests/test_torch_train.py's (the tiny M1 at 8x32x32, numpy-
drawn parameters) at a global batch of 4. Tolerances are ``check_step``'s
(tests/test_torch_train.py): metrics rtol 1e-5; gradients max|diff| /
max(1, max|ref|) within 1e-4 of the port's fp64 evaluation and of its
one-process fp32 step (5e-3 on the leaves whose gradient is 0 but for
rounding), and JAX's mesh step within 5e-3 of the fp64 evaluation.
All cases run in one world of 4 ranks; meshes of 2 leave ranks 2 and 3
out.
"""

import jax
import numpy as np
import pytest

from prostatemr_3d_cad_cspca_tpu.augment import AugmentParams as JAugmentParams
from prostatemr_3d_cad_cspca_tpu.ops.edt import signed_distance_map
from prostatemr_3d_cad_cspca_tpu.parallel import mesh as jmesh
from prostatemr_3d_cad_cspca_tpu.parallel.sharding import param_partition_spec as jspec
from prostatemr_3d_cad_cspca_tpu.train import trainer as jt
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.parallel.sharding import param_partition_spec
from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt
from test_torch_dist_util import _steps, run_world
from test_torch_train import (CLI_AUGMENT, JAX_TOL, KINDS, KW, METRIC_RTOL, PORT_TOL,
                              ZERO_GRAD, labelled_batch)
from test_torch_util import (BranchReplay, jax_model, jax_step_grads, leaf_errors,
                             port_model, port_step_grads, record_train_draws)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

B = 4
TP_KW = dict(input_spatial_dims=(4, 16, 16), input_channels=3,
             filters=(4, 8, 16, 32, 128),  # the widest stage splits over model=2
             strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
             dropout_rate=0.0)
# (world, loss, kind, augmented): the DP cases held against JAX's mesh step
DP_CASES = [(2, "distribution_focal", "mc", False),
            (2, "region_boundary", "deterministic", False),
            (4, "distribution_focal", "deterministic", True),
            (4, "region_boundary", "mc", False)]


def _batch(seed, loss_mode):
    batch = labelled_batch(seed, batch=B)
    if loss_mode == "region_boundary":
        batch["dist_map"] = signed_distance_map(batch["detection"][..., 1:])
    return batch


@pytest.fixture(scope="module")
def models():
    return {kind: jax_model(3, **KW, **kw) for kind, kw in KINDS.items()}


@pytest.fixture(scope="module")
def world(models):
    """One world of 4 ranks runs every case of this module."""
    mc, det = models["mc"], models["deterministic"]
    steps_batches = [labelled_batch(20 + i, batch=B) for i in range(2)]
    tp = jax_model(5, **TP_KW)
    tp_batch = labelled_batch(30, batch=B, spatial=TP_KW["input_spatial_dims"])
    cases, refs = {"mc": [], "deterministic": []}, {}
    for i, (n, loss_mode, kind, aug) in enumerate(DP_CASES):
        jm = models[kind]
        batch, key = _batch(10 + i, loss_mode), jax.random.PRNGKey(40 + i)
        kw = {"augment_params": CLI_AUGMENT, "train_obj": "lesion"} if aug else {}
        augment = (JAugmentParams.from_list(CLI_AUGMENT), "lesion", batch) if aug else None
        draws = record_train_draws(jm, batch["image"], key, augment)
        refs[i] = (batch, key, kw, draws)
        cases[kind].append(("grads", (n, 1), (batch, draws, {"loss_mode": loss_mode, **kw})))
    general = [("steps", (2, 1), (steps_batches, [5, 6], kind)) for kind in ("scan", "accum")]
    general += [("fit", (2, 1), (steps_batches, 2, None))]
    tp_cases = [("tp", shape, (tp_batch, 7, 64)) for shape in ((4, 1), (2, 2))]
    got = {}
    for kind, jm in (("mc", mc), ("deterministic", det)):
        got[kind] = run_world("train_world", 4, jm.config, from_jax_params(jm.params),
                              cases[kind] + (general if kind == "deterministic" else []))
    got["tp"] = run_world("train_world", 4, tp.config, from_jax_params(tp.params), tp_cases)
    return dict(got=got, refs=refs, steps_batches=steps_batches, tp=tp, tp_batch=tp_batch)


def _check(dp, ref, exact, jg, jmet):
    """check_step's tolerances for a mesh step's (gradients, metrics): the
    metrics against JAX's and the one-process port's; the gradients against
    the fp64 evaluation (as the port's fp32 step) and against the
    one-process fp32 step, and JAX's against the fp64 evaluation on the
    leaves whose gradient is not 0 but for rounding (on those, JAX's fp32
    rounding grows with the loss: 5.2e-3 at the region/boundary loss of
    ~5.9e3 here, where check_step's cases see up to 3.1e-3 at ~3e3)."""
    grads, met = dp
    pg, pmet = ref
    for k in jmet:
        np.testing.assert_allclose(met[k], jmet[k], rtol=METRIC_RTOL, err_msg=k)
        np.testing.assert_allclose(met[k], pmet[k], rtol=METRIC_RTOL, err_msg=k)
    zero = {k for k, v in exact.items() if np.abs(v).max() <= ZERO_GRAD}
    for want in (exact, pg):
        for k, e in leaf_errors(grads, want).items():
            assert e <= (JAX_TOL if k in zero else PORT_TOL), (k, e)
    err = {k: e for k, e in leaf_errors(jg, exact).items() if k not in zero}
    worst = max(err, key=err.get)
    assert err[worst] <= JAX_TOL, (worst, err[worst])


@pytest.mark.parametrize("case", range(len(DP_CASES)),
                         ids=[f"world{n}-{loss}-{kind}{'-augment' if aug else ''}"
                              for n, loss, kind, aug in DP_CASES])
def test_data_parallel_step_matches_jax_mesh_step(models, world, case):
    n, loss_mode, kind, aug = DP_CASES[case]
    jm = models[kind]
    batch, key, kw, draws = world["refs"][case]
    jg, jmet = jax_step_grads(jm, batch, key, loss=jt.make_loss(loss_mode),
                              mesh=jmesh.make_mesh(n_data=n, devices=jax.devices()[:n]), **kw)
    loss = tt.make_loss(loss_mode)
    branches = BranchReplay()
    with branches.record():
        ref = port_step_grads(port_model(jm), batch, draws, loss=loss, **kw)
    with branches.replay():
        exact, _ = port_step_grads(port_model(jm, dtype="float64"), batch, draws, loss=loss,
                                   **kw)
    idx = [i for i, c in enumerate(DP_CASES) if c[2] == kind].index(case)
    results = [r[idx] for r in world["got"][kind]]
    assert all(r is None for r in results[n:])  # outside the mesh
    for r in results[:n]:  # every member: the global batch's step
        _check(r, ref, exact, jg, jmet)
    if kind == "mc":  # every site's mask was replayed, and is live
        assert len([k for k in draws if k.startswith("drop")]) == 8


@pytest.mark.parametrize("kind", ["scan", "accum"])
def test_multi_step_programs_on_a_mesh(models, world, kind):
    """scan_steps=2 and accum_steps=2 at world 2 (SGD momentum 1e-3, the
    deterministic model) against the one-process programs: the metrics at
    rtol 1e-5, the parameters within 1e-4 of max(1, |leaf|)."""
    det = models["deterministic"]
    idx = 2 + ["scan", "accum"].index(kind)
    want_p, want_m = _steps(port_model(det), None, tt.make_optimizer("momentum", 1e-3),
                            world["steps_batches"], [5, 6], kind)
    for got in world["got"]["deterministic"][:2]:
        got_p, got_m = got[idx]
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=METRIC_RTOL, err_msg=k)
        errs = leaf_errors(got_p, want_p)
        assert max(errs.values()) <= PORT_TOL, max(errs, key=errs.get)


def test_fit_on_a_mesh(models, world):
    """fit(mesh=) at world 2: the one-process fit's losses and parameters
    (SGD momentum 1e-3, where an update follows its gradient)."""
    det = models["deterministic"]
    model = port_model(det)
    batches = world["steps_batches"]
    hist = tt.fit(model, iter(batches * 2), epochs=2, steps_per_epoch=2,
                  optimizer=tt.make_optimizer("momentum", 1e-3), verbose=0)
    for got in world["got"]["deterministic"][:2]:
        loss, params = got[4]
        np.testing.assert_allclose(loss, hist["loss"], rtol=METRIC_RTOL)
        errs = leaf_errors(params, {k: v.detach().numpy()
                                    for k, v in model.net.named_parameters()})
        assert max(errs.values()) <= PORT_TOL, max(errs, key=errs.get)
    assert all(r[4] is None for r in world["got"]["deterministic"][2:])


def test_tensor_parallel_step(world):
    """data 2 x model 2 against data 4 (JAX tests/test_infer_and_parallel.py:
    118-166): the loss at rtol 1e-4; the state split as JAX's
    param_partition_spec splits it (the widest kernels' last axis, their
    biases, scales and momentum traces, halves on each rank); the updated
    parameters those of the data-parallel step."""
    tp = world["tp"]
    dp, tpr = world["got"]["tp"][0][0], world["got"]["tp"][0][1]
    np.testing.assert_allclose(tpr[1]["loss"], dp[1]["loss"], rtol=1e-4)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jspec(tp.params, min_channels=64, axis_size=2),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    want = {".".join(p.key for p in path): tuple(spec) for path, spec in flat}
    port = param_partition_spec(from_jax_params(tp.params), min_channels=64, axis_size=2)
    assert {k: tuple(s) for k, s in port.items()} == want
    split = {k for k, s in port.items() if "model" in s}
    assert split and any(k.endswith("kernel") for k in split)
    full = from_jax_params(tp.params)
    for r in world["got"]["tp"]:
        _, _, shards, traces = r[1]
        assert set(shards) == split
        for k in split:
            half = tuple(d // 2 if i == len(full[k].shape) - 1 else d
                         for i, d in enumerate(full[k].shape))
            assert shards[k] == traces[k] == half, k
        errs = leaf_errors(r[1][0], world["got"]["tp"][0][0][0])
        assert max(errs.values()) <= PORT_TOL, max(errs, key=errs.get)
