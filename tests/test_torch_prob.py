"""The hierarchical probabilistic M1 in the port against the JAX package, on
the CPU: ``DiagGaussian`` and ``kl_diag_gaussians``, ``M1Core.ladder`` with
injected latents and with the means (called on the JAX side through flax
``method=``, as tests/test_tf_prob_oracle.py does), ``M1Net``'s outputs in
its fused, five-pass and strict-slicing modes, the detect head, checkpoints
and serving, and the port's own stream of draws (``prng``).

The main model carries every option at once: dense skips (so the ladder's
stage-0 stitch has six parts), deep supervision and latent dims (2, 1, 1, 0)
on 4 input channels (3 image + 1 label). Dropout is 'standard' at 0.5, off
at inference, so the latents are the only draws; they are JAX's, recorded
and injected into the port (tests/test_torch_util.py). fp32 atol 2e-5;
bf16: mean |softmax diff| <= 1e-2 with the same latents.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import serve as jserve
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu.ops import distributions as jdist
from prostatemr_3d_cad_cspca_tpu_torch import prng
from prostatemr_3d_cad_cspca_tpu_torch import serve as tserve
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from prostatemr_3d_cad_cspca_tpu_torch.ops import distributions as tdist
from test_torch_util import (ATOL, DIMS, SPATIAL, TINY, assert_tree_close, inputs,
                             jax_model, port_model, record, to_np)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

PROB = dict(input_channels=4, probabilistic=True, prob_latent_dims=DIMS,
            dense_skip=True, deep_supervision=True)
OUTS = ("prob_infer_conv", "prob_train_conv", "prob_kl", "prob_softmax", "infer_softmax")
MODES = {"fused": {}, "five_pass": dict(fused_prob_passes=False),
         "strict": dict(strict_reference_slicing=True)}


@pytest.fixture(scope="module")
def jprob():
    return jax_model(0, **PROB)


@pytest.fixture(scope="module")
def batch():
    return inputs(1, 4)


def _gauss(rng, shape):
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(scale=0.3, size=shape).astype(np.float32))


# ------------------------------------------------------------- distributions
def test_kl_diag_gaussians_matches_jax():
    rng = np.random.default_rng(0)
    (qm, qs), (pm, ps) = _gauss(rng, (2, 3, 4, 5, 3)), _gauss(rng, (2, 3, 4, 5, 3))
    want = jdist.kl_diag_gaussians(jdist.DiagGaussian.from_mu_logsigma(qm, qs),
                                   jdist.DiagGaussian.from_mu_logsigma(pm, ps))
    t = torch.from_numpy
    got = tdist.kl_diag_gaussians(tdist.DiagGaussian.from_mu_logsigma(t(qm), t(qs)),
                                  tdist.DiagGaussian.from_mu_logsigma(t(pm), t(ps)))
    assert got.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # fp32 whatever the inputs' dtype, as the JAX function
    half = tdist.kl_diag_gaussians(
        tdist.DiagGaussian.from_mu_logsigma(t(qm).bfloat16(), t(qs).bfloat16()),
        tdist.DiagGaussian.from_mu_logsigma(t(pm).bfloat16(), t(ps).bfloat16()))
    assert half.dtype == torch.float32


def test_diag_gaussian_clips_log_sigma_and_samples_by_reparameterization():
    rng = np.random.default_rng(1)
    mu, logsig = _gauss(rng, (2, 3, 3, 3, 2))
    logsig = logsig * 10  # well outside the clip
    want = jdist.DiagGaussian.from_mu_logsigma(mu, logsig)
    got = tdist.DiagGaussian.from_mu_logsigma(torch.from_numpy(mu), torch.from_numpy(logsig))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    assert float(got.scale.max()) <= np.exp(0.1) * (1 + 1e-6)
    z = got.sample(torch.Generator().manual_seed(3))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(z.numpy(), (got.loc + got.scale * eps).numpy())
    zb = tdist.DiagGaussian(got.loc.bfloat16(), got.scale.bfloat16()).sample(
        torch.Generator().manual_seed(3))
    assert zb.dtype == torch.bfloat16  # eps drawn in fp32, cast to loc's dtype


# -------------------------------------------------------------------- ladder
@pytest.mark.parametrize("how", ["z_q", "mean"])
def test_ladder_matches_jax(jprob, batch, how):
    """The prior's ladder with injected latents or with the means, with what
    it feeds (the final decoder's logits, the deep-supervision heads'
    softmax). Its features reach |x| ~ 13 after instance norms over 1-64
    voxels, where JAX's own fp32 result lies up to 4e-5 from the exact
    value (the port's lies within 1.1e-5). So both are held to the exact
    value, the port's ladder run in fp64 (its plain twins take fp64): the
    port's fp32 result within fp32 atol 2e-5 of it, JAX's fp32 result
    within 5e-5. M1Net's outputs below hold the two fp32 results to each
    other at 2e-5."""
    image = batch[..., :3]
    rng = np.random.default_rng(7)
    z_spatial = [(1, 1, 1), (2, 2, 2), (4, 4, 4), (4, 8, 8)]  # levels at res 3..0
    z_q = tuple(None if d == 0 else rng.normal(size=(2, *s, d)).astype(np.float32)
                for d, s in zip(DIMS, z_spatial))

    def kw(to):
        if how == "mean":
            return dict(prob_mean=True)
        return dict(prob_z_q=tuple(None if z is None else to(z) for z in z_q))

    def jax_ladder(m, x):
        trunk = m.prior.trunk(x, False)
        lad = m.prior.ladder(trunk, **kw(jnp.asarray))
        return lad, m.final_decoder(lad["prob_decoder_features"]), \
            m.prior.assemble_outputs(trunk, lad)["y_softmax"]

    want, want_logits, want_heads = jprob.net.apply(
        {"params": jprob.params}, jnp.asarray(image), method=jax_ladder)
    want = dict(want)

    def port_ladder(model, x):
        net = model.net
        with torch.no_grad():
            trunk = net.prior.trunk(x)
            lad = net.prior.ladder(trunk, **kw(torch.from_numpy))
            return lad, net.final_decoder(lad["prob_decoder_features"]), \
                net.prior.assemble_outputs(trunk, lad)["y_softmax"]

    got = port_ladder(port_model(jprob), torch.from_numpy(image))
    exact = to_np(port_ladder(port_model(jprob, dtype="float64"),
                              torch.from_numpy(image).double()))
    assert exact[0]["prob_decoder_features"].dtype == np.float64
    assert_tree_close(got, exact)
    assert_tree_close(exact, (want, want_logits, want_heads), atol=5e-5)
    if how == "z_q":  # the injected latents are the ones used
        for g, z in zip(got[0]["prob_used_latents"], z_q):
            assert (g is None) == (z is None)
            if z is not None:
                np.testing.assert_array_equal(g.numpy(), z)


# -------------------------------------------------------------------- M1Net
@pytest.mark.parametrize("mode", sorted(MODES))
def test_m1net_outputs_match_jax_with_injected_latents(jprob, batch, mode):
    jm = JM1(**{**TINY, **PROB, **MODES[mode]}, init_params=False)
    jm.params = jprob.params
    want, latents = record(jm, batch, seed=3)
    assert sorted(latents) == ["p_sample/z_0", "p_sample/z_1", "p_sample/z_2",
                               "q_sample/z_0", "q_sample/z_1", "q_sample/z_2"]
    got = port_model(jm).apply(None, batch, rng=latents)
    assert got["prob_softmax"].shape == (2, *SPATIAL, 8)  # the deep-supervision concat
    assert float(got["prob_kl"]) > 0
    assert_tree_close({k: got[k] for k in OUTS}, {k: want[k] for k in OUTS})


def test_prob_inputs_split_into_contiguous_tensors(jprob, batch):
    """The kernels take contiguous NDHWC tensors: the prior's image is a
    copy of the leading channels, not a strided view."""
    net = port_model(jprob).net
    image, image_label = net._split(torch.from_numpy(batch))
    assert image.is_contiguous() and image_label.is_contiguous()
    assert image.shape[-1] == 3 and image_label.shape[-1] == 4


def test_strict_slicing_feeds_the_last_image_channel_as_label(jprob, batch):
    """The reference defect (networks.py:301) changes the posterior's input:
    with the latents held, the outputs that depend on it move."""
    jm = JM1(**{**TINY, **PROB}, init_params=False)
    jm.params = jprob.params
    _, latents = record(jm, batch, seed=3)
    fixed = port_model(jm).apply(None, batch, rng=latents)
    strict = port_model(jm, strict_reference_slicing=True).apply(None, batch, rng=latents)
    torch.testing.assert_close(strict["prob_infer_conv"], fixed["prob_infer_conv"])
    assert not torch.allclose(strict["prob_train_conv"], fixed["prob_train_conv"])


def test_detect_head_matches_jax_and_the_full_forward(jprob, batch):
    """detect computes the prior trunk, the prior's sampling ladder and the
    final decoder only; it equals JAX's infer_softmax and, bit for bit, the
    port's own full forward under the same latents."""
    want, latents = record(jprob, batch, seed=5)
    model = port_model(jprob)
    got = model.predict(batch, rng=latents)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["infer_softmax"]), atol=ATOL)
    full = model.apply(None, batch, rng=latents)["infer_softmax"]
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    calls = []
    hooks = [model.net.posterior.register_forward_hook(lambda *a: calls.append(1)),
             model.net.prior.dsy1_logits.register_forward_hook(lambda *a: calls.append(1))]
    model.predict(batch, rng=latents)
    for h in hooks:
        h.remove()
    assert calls == []


def test_bf16_detect_stays_near_jax_bf16(jprob, batch, tmp_path):
    path = str(tmp_path / "prob.npz")
    jprob.save(path)
    jb = JM1.load(path, dtype=jnp.bfloat16)
    want, latents = record(jb, batch, seed=5)
    got = TM1.load(path, device="cpu", dtype=torch.bfloat16).predict(batch, rng=latents)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want["infer_softmax"], np.float32))
    assert diff.mean() <= 1e-2 and diff.max() <= 0.25, (diff.mean(), diff.max())


# -------------------------------------------------------------- checkpoints
def test_jax_prob_checkpoint_loads_with_every_leaf_matched(jprob, batch, tmp_path):
    path = str(tmp_path / "prob.npz")
    jprob.save(path)
    model = TM1.load(path, device="cpu")
    assert model.config == jprob.config
    flat = from_jax_params(jprob.params)
    assert set(model.params) == set(flat)  # mu_logsig_3 absent, as in flax
    assert "prior.mu_logsig_3.kernel" not in flat and "final_decoder.logits.kernel" in flat
    for key, leaf in flat.items():
        assert torch.equal(model.params[key], leaf), key
    model.load_weights(path, strict=True)
    # the prior takes the image channels, the posterior image + label
    assert model.params["prior.conve0.kernel"].shape[3] == 3
    assert model.params["posterior.conve0.kernel"].shape[3] == 4


def test_port_prob_checkpoint_loads_in_jax(jprob, batch, tmp_path):
    path = str(tmp_path / "port.npz")
    port_model(jprob).save(path)
    back = JM1.load(path)
    want, _ = record(jprob, batch, seed=2)
    got, _ = record(back, batch, seed=2)
    assert_tree_close({k: got[k] for k in OUTS}, {k: want[k] for k in OUTS}, atol=0)


def test_three_latent_dims_pad_with_zero_as_jax():
    """M1's default prob_latent_dims has 3 entries; both packages pad a 0."""
    jm = jax_model(1, input_channels=4, probabilistic=True, prob_latent_dims=(3, 2, 1))
    model = port_model(jm)
    assert set(model.params) == set(from_jax_params(jm.params))
    assert model.net.prior.prob_latent_dims == (3, 2, 1, 0)


# ------------------------------------------------------------ draws (prng)
def test_scoped_mapping_reads_under_its_prefix():
    m = {"stage1/p_sample/z_0": 1, "stage1/prior/drope1": 2, "stage2/q_sample/z_1": 3}
    s = prng.scope(prng.scope(m, "stage1"), "p_sample")
    assert s["z_0"] == 1 and "drope1" not in s and list(s) == ["z_0"]
    gen = torch.Generator()
    assert prng.scope(gen, "stage1") is gen and prng.scope(None, "prior") is None


def test_mc_prob_model_draws_the_same_bits_from_the_same_seed(jprob, batch):
    """Latent noise and Monte-Carlo dropout masks come from one generator in
    a fixed order: the same seed gives the same bits, another seed others."""
    model = port_model(jprob, dropout_mode="monte-carlo", dropout_rate=0.5)
    a = model.apply(None, batch, rng=11)
    b = model.apply(None, batch, rng=11)
    c = model.apply(None, batch, rng=12)
    for k in OUTS:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["prob_infer_conv"], c["prob_infer_conv"])
    assert torch.equal(model.predict(batch, rng=4), model.predict(batch, rng=4))
    with pytest.raises(ValueError, match="needs rng"):
        model.get_detect_model()(None, batch)


def test_mc_prob_session_gives_a_positive_std_and_repeats_per_seed(jprob, batch):
    model = port_model(jprob, dropout_mode="monte-carlo", dropout_rate=0.5)
    mean, std = tserve.InferenceSession(model, mc_iter=3, seed=2, device="cpu")(batch)
    again = tserve.InferenceSession(model, mc_iter=3, seed=2, device="cpu")(batch)
    assert std.shape == mean.shape == (2, *SPATIAL, 2)
    assert float(std.min()) >= 0 and float(std.max()) > 0
    np.testing.assert_array_equal(again[0], mean)
    np.testing.assert_array_equal(again[1], std)


# ------------------------------------------------------------------ serving
def _image_manifest(tmp_path, channels):
    rng = np.random.default_rng(9)
    path = str(tmp_path / f"img{channels}.npy")
    np.save(path, rng.normal(size=(*SPATIAL, channels)).astype(np.float32))
    man = str(tmp_path / f"m{channels}.csv")
    with open(man, "w") as f:
        f.write(f"p-id,image_path\ncase0,{path}\n")
    return man


def test_serve_run_with_a_probabilistic_checkpoint_follows_jax(tmp_path):
    """The JAX ``serve.run`` reads a test image's own channels only (no label
    channel, ``serve.py:528-540``), so a probabilistic checkpoint, whose
    input_channels count the label, fails on 3-channel images in both
    packages; 4-channel images serve in both, equal (latent dims 0: no
    draw)."""
    jm = jax_model(3, input_channels=4, probabilistic=True, prob_latent_dims=(0, 0, 0, 0))
    ckpt = str(tmp_path / "prob.npz")
    jm.save(ckpt)

    def run(pkg, man, out):
        argv = ["--MODEL", ckpt, "--MANIFEST", man, "--OUTPUT_DIR", str(tmp_path / out)]
        if pkg is tserve:
            argv += ["--DEVICE", "cpu"]
        return pkg.run(pkg.build_parser().parse_args(argv))

    man3 = _image_manifest(tmp_path, 3)
    with pytest.raises(Exception):
        run(jserve, man3, "j3")
    with pytest.raises(ValueError, match="input channels"):
        run(tserve, man3, "t3")
    man4 = _image_manifest(tmp_path, 4)
    want, got = run(jserve, man4, "j4"), run(tserve, man4, "t4")
    np.testing.assert_allclose(np.load(got[0]["detection_path"]),
                               np.load(want[0]["detection_path"]), atol=ATOL)
