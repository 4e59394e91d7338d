"""The port's export artifacts held to the JAX package on the CPU, on the
same numpy-drawn weights (tests/test_torch_util.py's tiny config): the
deterministic artifact within 2e-5 of JAX's ``export._detect_head`` at a
batch other than the traced one, a cascade's likewise; the MC and the
probabilistic programs fed JAX's own draws (its dropout keep-masks as
uniforms below or above the keep rate, its latents as the eps they imply)
within 2e-5 of JAX's forward on them; an ensemble with TTA within 2e-5 of
JAX's; and a JAX artifact's ``meta.json`` keys all present in the port's.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from prostatemr_3d_cad_cspca_tpu import ensemble as jens
from prostatemr_3d_cad_cspca_tpu import export as jexp
from prostatemr_3d_cad_cspca_tpu.models.m1_core import M1Core as JM1Core
from prostatemr_3d_cad_cspca_tpu_torch import export as exp
from test_torch_util import ATOL, inputs, jax_model, port_model
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

MC = dict(dropout_mode="monte-carlo", dropout_rate=0.5)
PROB = dict(input_channels=4, probabilistic=True, prob_latent_dims=(2, 1, 0, 0))


def _models(seed=0, **kw):
    jm = jax_model(seed, **{"input_channels": 3, **kw})
    return jm, port_model(jm)


def _exported(pm, path, **kw):
    exp.export_model(pm, path, **kw)
    return exp.ExportedModel.load(path, device="cpu")


def _jax_dropout_forward(jm, xs, key):
    """An eager flax forward of ``jm.net`` at inference with dropout key
    ``key``: (the detect head's softmax, {site: keep-mask})."""
    masks = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
            assert not (np.asarray(args[0]) == 0).any(), "an exact zero hides the mask"
            masks["/".join(p for p in mod.path if p != "core").rsplit("/", 1)[0]] = \
                np.asarray(out) != 0
        return out

    with nn.intercept_methods(interceptor):
        out = jm.net.apply({"params": jm.params}, jnp.asarray(xs), train=False,
                           rngs={"dropout": key})
    return np.asarray(out["y_softmax"][..., :jm.num_classes]), masks


def _jax_latent_forward(jm, x, seed):
    """An eager flax forward of a probabilistic ``jm.net``: (its
    infer_softmax, {latent path: the standard normal eps of each sampling
    level}), eps = (z - loc) / scale of the latent z the level used."""
    eps = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if (isinstance(mod, JM1Core) and context.method_name == "ladder"
                and not kwargs.get("prob_mean") and kwargs.get("prob_z_q") is None):
            name = {"prior": "p_sample", "posterior": "q_sample"}[mod.name]
            for i, (z, d) in enumerate(zip(out["prob_used_latents"],
                                           out["prob_distributions"])):
                if z is not None:
                    e = (np.asarray(z, np.float64) - np.asarray(d.loc, np.float64)) \
                        / np.asarray(d.scale, np.float64)
                    eps[f"{name}/z_{i}"] = e.astype(np.float32)
        return out

    key = jax.random.PRNGKey(seed)
    with nn.intercept_methods(interceptor):
        out = jm.net.apply({"params": jm.params}, jnp.asarray(x), train=False,
                           rngs={"dropout": key, "latent": jax.random.fold_in(key, 1)})
    return np.asarray(out["infer_softmax"]), eps




def test_mc_program_on_jax_draws_matches_jax(tmp_path):
    """The MC program fed the keep-masks JAX drew (as uniforms below or
    above the keep rate) against JAX's forward on those masks: mean and
    population std over the samples within 2e-5."""
    jm, pm = _models(**MC)
    loaded = _exported(pm, str(tmp_path / "mc2.zip"), mc_iter=2)
    x = inputs(3, 3)
    ys, masks = _jax_dropout_forward(jm, np.concatenate([x, x]), jax.random.PRNGKey(4))
    draws = [torch.from_numpy(np.where(masks[e["site"]], 0.0, 0.75).astype(np.float32))
             for e in loaded.meta["draws"]]
    with torch.no_grad():
        mean, std = loaded._prog(torch.from_numpy(x), draws)
    ys = ys.reshape(2, *x.shape[:-1], 2)
    np.testing.assert_allclose(mean.numpy(), ys.mean(0), atol=ATOL)
    np.testing.assert_allclose(std.numpy(), ys.std(0), atol=ATOL)




def test_meta_holds_every_key_of_a_jax_artifact(tmp_path):
    jm, pm = _models()
    jart, art = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jexp.export_model(jm, jart, platforms=("cpu",))
    exp.export_model(pm, art)
    with zipfile.ZipFile(jart) as z:
        jmeta = json.loads(z.read("meta.json"))
    with zipfile.ZipFile(art) as z:
        meta = json.loads(z.read("meta.json"))
        assert sorted(z.namelist()) == ["meta.json", "program.pt2"]
    assert set(jmeta) <= set(meta), set(jmeta) - set(meta)
    assert set(jmeta["config"]) <= set(meta["config"])
    for k in ("input_spatial_dims", "input_channels", "batch", "needs_rng", "mc_iter", "tta",
              "num_classes", "cascaded", "probabilistic", "num_members", "output",
              "transfer_dtype", "sliding_window", "format_version"):
        assert meta[k] == jmeta[k], k
    assert meta["torch"] == torch.__version__ and meta["traced_on"] == "cpu"
    assert meta["dtype"] == "float32" and set(meta["platforms"]) == {"cuda", "cpu"}


def test_deterministic_and_cascaded_artifacts_match_jax_detect_head(tmp_path):
    for kw, cin in (({}, 3), (dict(cascaded="noisy-or"), 6)):
        jm, pm = _models(**kw)
        loaded = _exported(pm, str(tmp_path / f"m{cin}.zip"))  # traced at batch 2
        jhead, _ = jexp._detect_head(jm, 1, False)
        x = inputs(cin, cin, batch=3)
        np.testing.assert_allclose(loaded.predict(x), np.asarray(jhead(x)), atol=ATOL)


def test_probabilistic_program_on_jax_latents_matches_jax(tmp_path):
    jm, pm = _models(**PROB)
    loaded = _exported(pm, str(tmp_path / "prob.zip"))
    x = inputs(3, 4)
    want, eps = _jax_latent_forward(jm, x, seed=5)
    with torch.no_grad():
        got = loaded._prog(torch.from_numpy(x),
                           [torch.from_numpy(eps[e["site"]]) for e in loaded.meta["draws"]])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_ensemble_tta_artifact_matches_jax(tmp_path):
    paths = []
    for i in (1, 2):
        _, pm = _models(seed=i)
        paths.append(str(tmp_path / f"f{i}.npz"))
        pm.save(paths[-1])
    from prostatemr_3d_cad_cspca_tpu_torch.ensemble import M1Ensemble

    loaded = _exported(M1Ensemble.load(paths, device="cpu"), str(tmp_path / "ens.zip"),
                       tta=True)
    x = inputs(6, 3)
    jm = jens.M1Ensemble.load(paths)
    want = jens.tta_detect(jm.get_detect_model())(jm.params, x)
    np.testing.assert_allclose(loaded.predict(x), np.asarray(want, np.float32), atol=ATOL)
