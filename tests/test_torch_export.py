"""The port's export (``export.py``) on the CPU: checkpoint -> one artifact
(a ``torch.export`` program with the weights inside) -> inference with no
model code. Mirrors JAX's tests/test_export.py case for case (deterministic
with a symbolic batch, fixed batch with a transfer dtype, MC mean and std,
probabilistic and cascaded, the CLI with an ensemble and TTA, the validate
gate; the serving cases are in tests/test_torch_export_serve.py) on the
tiny config of tests/test_torch_util.py: each artifact gives the live
port's bits on the same inputs and draws. An artifact holds K1-K4 as the
``pmr::`` operators (no aten convolution), as many as a live forward
calls, and K8 as ``pmr::se_mean`` and ``pmr::se_tail``, one each an SE
block; its draws follow the plan in ``meta.json``. The same artifacts
held to the JAX package: tests/test_torch_export_jax.py.
"""

import collections
import os

import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch import ensemble as tens
from prostatemr_3d_cad_cspca_tpu_torch import export as exp
from prostatemr_3d_cad_cspca_tpu_torch import infer as tinfer
from prostatemr_3d_cad_cspca_tpu_torch import prng
from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution, normalization
from test_torch_util import SPATIAL, inputs, jax_model, port_model
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

MC = dict(dropout_mode="monte-carlo", dropout_rate=0.5)
PROB = dict(input_channels=4, probabilistic=True, prob_latent_dims=(2, 1, 0, 0))
OPERATORS = {"conv3d": "pmr.conv3d.default", "conv3d_pair": "pmr.conv3d_pair.default",
             "conv3d_transpose": "pmr.conv3d_transpose.default",
             "in_stats": "pmr.in_stats.default", "in_apply": "pmr.in_apply.default"}


def _models(seed=0, **kw):
    jm = jax_model(seed, **{"input_channels": 3, **kw})
    return jm, port_model(jm)


def _graph_targets(gm):
    """Every call_function target of an exported module and its subgraphs."""
    out = collections.Counter(str(n.target) for n in gm.graph.nodes
                              if n.op == "call_function")
    for sub in gm.children():
        if isinstance(sub, torch.fx.GraphModule):
            out.update(_graph_targets(sub))
    return out


def _live_calls(fn):
    """K1-K4 calls of ``fn()`` counted at the wrappers the model calls
    (``port_support.py``'s meta trace does the same on the meta device)."""
    calls = collections.Counter()
    mods = {"conv3d": convolution, "conv3d_pair": convolution, "conv3d_transpose": convolution,
            "in_stats": normalization, "in_apply": normalization}
    orig = {k: getattr(m, k) for k, m in mods.items()}

    def counting(name):
        def wrapper(*a, **kw):
            calls[name] += 1
            return orig[name](*a, **kw)
        return wrapper

    try:
        for k, m in mods.items():
            setattr(m, k, counting(k))
        fn()
    finally:
        for k, m in mods.items():
            setattr(m, k, orig[k])
    return dict(calls)


# ------------------------------------------------------------------ tests
def test_export_deterministic_symbolic_batch(tmp_path):
    _, pm = _models()
    art = str(tmp_path / "m1.zip")
    exp.export_model(pm, art)  # traced at batch 2
    loaded = exp.ExportedModel.load(art, device="cpu")
    assert not loaded.needs_rng and loaded.num_classes == 2
    assert loaded.meta["batch"] is None and loaded.meta["draws"] is None
    for b in (1, 3):  # symbolic batch: one artifact, any batch
        x = inputs(b, 3, batch=b)
        got = loaded.predict(x)
        assert got.dtype == np.float32 and got.shape == (b, *SPATIAL, 2)
        np.testing.assert_array_equal(got, pm.predict(x).numpy())


def test_exported_graph_calls_the_operators_a_live_forward_launches(tmp_path):
    """No aten convolution in the artifact: K1-K4 are the ``pmr::``
    operators, exactly as many as a live forward calls (the launches on a
    card), for a deterministic and an MC-stacked forward: at the tiny widths
    two SE blocks (f = 8 and 16) run their first and projection convs as
    one K1 pair."""
    for kw, mc in (({}, 1), (MC, 3)):
        _, pm = _models(**kw)
        art = str(tmp_path / f"g{mc}.zip")
        exp.export_model(pm, art, mc_iter=mc)
        targets = _graph_targets(exp.ExportedModel.load(art, device="cpu")._prog)
        assert not [t for t in targets if "conv" in t and not t.startswith("pmr.")], targets
        x = inputs(0, 3)
        live = _live_calls(lambda: tinfer.mc_predict(pm.get_detect_model(), None, x,
                                                     prng.generator(0, "cpu"), mc))
        assert live == {"conv3d": 46, "conv3d_pair": 2, "conv3d_transpose": 4, "in_stats": 37,
                        "in_apply": 37}
        assert {k: targets[op] for k, op in OPERATORS.items()} == live


def test_cpu_traced_mc_graph_holds_the_se_tail_operators(tmp_path):
    """An MC artifact traced on the CPU holds K8 as ``pmr::se_mean`` and
    ``pmr::se_tail``, one each an SE block (8 in the tiny trunk), every
    apply given its site's uniforms and keep, so the program launches K8 wherever it
    is served; its outputs are the live model's bits."""
    _, pm = _models(**MC)
    art = str(tmp_path / "mc.zip")
    exp.export_model(pm, art, mc_iter=2)
    loaded = exp.ExportedModel.load(art, device="cpu")
    prog = loaded._prog
    targets = _graph_targets(prog)
    assert (targets["pmr.se_mean.default"], targets["pmr.se_tail.default"]) == (8, 8)
    applies = [n for n in prog.graph.nodes if str(n.target) == "pmr.se_tail.default"]
    assert all(n.args[3] is not None for n in applies)
    assert [n.args[4] for n in applies] == [0.5] * 7 + [0.75]  # dropd0 at half the rate
    x = inputs(3, 3)
    mean, std = loaded.predict(x, rng=5)
    want = tinfer.mc_predict(pm.get_detect_model(), None, x, prng.generator(5, "cpu"),
                             num_samples=2, reduce="mean_std")
    np.testing.assert_array_equal(mean, want[0].numpy())
    np.testing.assert_array_equal(std, want[1].numpy())


def test_export_fixed_batch_and_transfer_dtype(tmp_path):
    _, pm = _models()
    art = str(tmp_path / "m1_b2.zip")
    exp.export_model(pm, art, batch=2, transfer_dtype="float16")
    loaded = exp.ExportedModel.load(art, device="cpu")
    x = inputs(1, 3)
    got = loaded.predict(x)
    assert got.dtype == np.float32  # fp32 on the host, fp16 out of the program
    np.testing.assert_allclose(got, pm.predict(x).numpy(), atol=2e-3)
    np.testing.assert_array_equal(got, pm.predict(x).half().float().numpy())
    with pytest.raises(ValueError, match="fixed batch 2"):
        loaded.predict(x[:1])


def test_export_mc_dropout_mean_std(tmp_path):
    _, pm = _models(**MC)
    art = str(tmp_path / "mc.zip")
    exp.export_model(pm, art, mc_iter=3)
    loaded = exp.ExportedModel.load(art, device="cpu")
    assert loaded.meta["output"] == "mean_std"
    # the draw plan: the trunk's eight sites in the forward's order, each a
    # uniform of the activation's shape with the three samples on the batch
    plan = loaded.meta["draws"]
    assert [e["site"] for e in plan] == ["drope1", "drope2", "drope3", "drope4",
                                         "dropd3", "dropd2", "dropd1", "dropd0"]
    assert all(e["kind"] == "uniform" and e["dtype"] == "float32" and e["path"] == []
               and e["shape"][0] == "3*b" for e in plan)
    assert plan[0]["shape"][1:] == [4, 8, 8, 8]  # drope1, after serse1's (1, 2, 2) stride

    x = inputs(2, 3)
    mean, std = loaded.predict(x, rng=7)
    assert mean.shape == (2, *SPATIAL, 2) and std.shape == mean.shape
    # the same generator, the same bits as the live composition
    rm, rs = tinfer.mc_predict(pm.get_detect_model(), None, x, prng.generator(7, "cpu"),
                               num_samples=3, reduce="mean_std")
    np.testing.assert_array_equal(mean, rm.numpy())
    np.testing.assert_array_equal(std, rs.numpy())
    # self-advancing draws: two rng-free calls differ
    a, _ = loaded.predict(x)
    b, _ = loaded.predict(x)
    assert not np.allclose(a, b, atol=1e-6)


def test_export_probabilistic_and_cascaded(tmp_path):
    _, pm = _models(**PROB)
    art = str(tmp_path / "prob.zip")
    exp.export_model(pm, art)
    loaded = exp.ExportedModel.load(art, device="cpu")
    plan = loaded.meta["draws"]
    assert [(e["site"], e["kind"]) for e in plan] == [("p_sample/z_0", "normal"),
                                                      ("p_sample/z_1", "normal")]
    x = inputs(3, 4)
    got = loaded.predict(x, rng=5)
    np.testing.assert_array_equal(got, pm.predict(x, rng=5).numpy())

    _, casc = _models(cascaded="noisy-or")
    cart = str(tmp_path / "casc.zip")
    exp.export_model(casc, cart)
    cl = exp.ExportedModel.load(cart, device="cpu")
    assert cl.meta["input_channels"] == 6 and cl.input_channels == 3
    xc = inputs(4, 6)
    got = cl.predict(xc)  # stacked two-exam channels, the final stage's output
    live = casc.get_detect_model()(None, (xc[..., :3], xc[..., 3:]))[-1]
    np.testing.assert_array_equal(got, live.numpy())


def test_export_cli_ensemble_with_tta(tmp_path):
    paths = []
    for i in (1, 2):
        _, pm = _models(seed=i)
        paths.append(str(tmp_path / f"f{i}.npz"))
        pm.save(paths[-1])
    art = str(tmp_path / "ens.zip")
    out = exp.main(["--MODEL", ",".join(paths), "--OUT", art, "--DEVICE", "cpu",
                    "--TTA", "1"])
    loaded = exp.ExportedModel.load(out, device="cpu")
    assert loaded.meta["num_members"] == 2 and loaded.meta["tta"]

    x = inputs(6, 3)
    got = loaded.predict(x)
    ens = tens.M1Ensemble.load(paths, device="cpu")
    with torch.no_grad():
        live = tens.tta_detect(ens.get_detect_model())(None, torch.from_numpy(x))
    np.testing.assert_array_equal(got, live.numpy())


def test_export_cli_validate_gate(tmp_path, capsys, monkeypatch):
    """--VALIDATE (default on) reloads the artifact and checks a random
    forward against the live model on the same draws (MC under a transfer
    dtype here); an artifact that deviates is deleted and the CLI raises."""
    _, pm = _models(**MC)
    ckpt = str(tmp_path / "mc.npz")
    pm.save(ckpt)
    art = str(tmp_path / "v.zip")
    exp.main(["--MODEL", ckpt, "--OUT", art, "--DEVICE", "cpu", "--MC_ITER", "2",
              "--TRANSFER_DTYPE", "float16"])
    assert "Validated: artifact == live model" in capsys.readouterr().out
    assert os.path.exists(art)

    real = exp.export_model

    def tampered(model, path, **kw):  # a weight moves after the export
        out = real(model, path, **kw)
        with torch.no_grad():
            model.net.core.logits.bias[-1] += 0.5  # the foreground logit
        return out

    monkeypatch.setattr(exp, "export_model", tampered)
    bad = str(tmp_path / "bad.zip")
    with pytest.raises(AssertionError, match="do not deploy"):
        exp.main(["--MODEL", ckpt, "--OUT", bad, "--DEVICE", "cpu", "--MC_ITER", "2"])
    assert not os.path.exists(bad)


