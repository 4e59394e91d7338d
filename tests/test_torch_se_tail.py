"""K8 (``ops/se_tail.py``, ``csrc/se_tail.cu``): an SE block's
squeeze-excite tail and the MC dropout after it.

On the CPU: the twins against the torch chain they replace, bit for bit (the
squeeze's mean, gate, shortcut, LReLU and flax's dropout); an SE block
through the fused call path against the plain one; a tiny probabilistic
forward through the fused call path, drawn from a generator, against the
same forward replayed from its recorded keep-masks and latents (the draws'
order and shapes unchanged); and each condition that keeps the plain path.
On the CPU the fused call path's wrappers run their twins. On a card
(marked ``cuda``, skipped without one): the apply against its twin, bit for
bit, given the same gate, at every served SE shape at batch 2 and at ragged
widths and unaligned bases; the sums against fp32 sums, and twice the same
bits; the launches a served forward. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_se_tail.py
"""

import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch import prng
from prostatemr_3d_cad_cspca_tpu_torch.models import M1, blocks
from prostatemr_3d_cad_cspca_tpu_torch.ops import se_tail as k8
from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import ConvConfig
from prostatemr_3d_cad_cspca_tpu_torch.ops.normalization import global_spatial_mean
from port_support import CFG1, PROB, PROB_DENSE, trace_se_shapes
from test_torch_dist_util import one_torch_thread  # noqa: F401  (autouse)

DTYPES = [torch.float32, torch.bfloat16]
KW = dict(input_spatial_dims=(4, 16, 16), input_channels=4, num_classes=2,
          filters=(4, 8, 12, 16, 24),
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
          se_reduction=(2, 2, 2, 2, 2), summary=False, dropout_mode="monte-carlo",
          probabilistic=True, prob_latent_dims=(3, 2, 1, 0), device="cpu")


def _operands(shape, dtype, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2).to(dtype).to(device)
    res = torch.randn(shape, generator=g).to(dtype).to(device)
    s = torch.sigmoid(torch.randn((shape[0], 1, 1, 1, shape[-1]), generator=g))
    return x, s.to(dtype).to(device), res


def _chain(x, s, res, rate, gen):
    """The torch chain K8's apply replaces: gate, shortcut, LReLU and the
    dropout that follows the block (``blocks.dropout``)."""
    out = blocks.leaky_relu01((x * s) * res)
    return out if rate == 0.0 else blocks.dropout(out, rate, gen, "site")


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The K8 applies the blocks call (on the CPU, the wrappers run their
    twins), recorded."""
    calls = []
    real = blocks.se_tail

    def spy(x, s, residual, u=None, keep=1.0):
        calls.append((tuple(x.shape), u is not None, keep))
        return real(x, s, residual, u, keep)

    monkeypatch.setattr(blocks, "se_tail", spy)
    return calls


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("keep", [0.5, 0.75])
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_is_the_chain(dtype, keep, masked):
    """The twins give the chain's bits: the mean ``global_spatial_mean``'s,
    the apply the gate, shortcut, LReLU and the dropout drawn from the same
    generator's uniforms."""
    x, s, res = _operands((2, 3, 6, 5, 8), dtype, seed=int(keep * 4) + masked)
    torch.testing.assert_close(k8.se_mean_plain(x), global_spatial_mean(x), rtol=0, atol=0)
    rate = 1.0 - keep if masked else 0.0
    want = _chain(x, s, res, rate, torch.Generator().manual_seed(7))
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(7)) if masked else None
    got = k8.se_tail(x, s, res, u, keep if masked else 1.0)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if masked:
        assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_fused_path_is_the_plain_one(fused_on_cpu, dtype, rate):
    """An SE block and its dropout through the fused call path give the
    plain path's bits and draw the same uniforms; one K8 apply, masked where
    the dropout is active."""
    torch.manual_seed(0)
    blk = blocks.SEResNetBottleNeck(6, 8, (1, 3, 3), (1, 2, 2), 2, ConvConfig(dtype=dtype))
    for p in blk.parameters():
        torch.nn.init.normal_(p, 0.0, 0.4)
    drop = blocks.ConfigurableDropout(rate, "monte-carlo", "drope1")
    x = torch.randn((2, 3, 8, 6, 6)).to(dtype)
    with torch.no_grad():
        got = blk(x, None, (drop, False, torch.Generator().manual_seed(3)))
        assert fused_on_cpu == [((2, 3, 4, 3, 8), rate > 0, 1.0 - rate)]
        plain = drop(blk(x), False, torch.Generator().manual_seed(3))
        assert len(fused_on_cpu) == 1  # no dropout handed in: the plain ops
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def _replay_map(core, rec, out):
    """The mask map of a recorded forward: each dropout site's keep-mask
    (its uniforms below its keep) and each sampled level's latent."""
    rates = {m.site: m.rate for m in core.modules()
             if isinstance(m, blocks.ConfigurableDropout)}
    masks = {e["site"]: d < 1.0 - rates[e["site"]]
             for e, d in zip(rec.plan, rec.draws) if e["kind"] == "uniform"}
    latents = {f"z_{i}": z for i, z in enumerate(out["prob_used_latents"]) if z is not None}
    return {**masks, **latents}


@pytest.mark.parametrize("dtype", DTYPES)
def test_prob_forward_draws_as_the_replay(fused_on_cpu, dtype):
    """A tiny probabilistic net's forward (trunk and sampling ladder, MC
    dropout 0.5) through the fused call path, from a generator, is bit for
    bit the same forward replayed from its recorded keep-masks and latents,
    which takes the plain path: the uniforms are drawn in the same order at
    the same shapes."""
    core = M1(**KW, seed=0, dtype=dtype).net.prior
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 16, 16, 3))
                         .astype(np.float32))
    rec = prng.DrawRecorder(torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = core(x, rng=prng.Draws(rec))
        assert len(fused_on_cpu) == 12 and all(masked for _, masked, _ in fused_on_cpu)
        sites = [e["site"] for e in rec.plan if e["kind"] == "uniform"]
        assert sites == [*(f"drope{i}" for i in range(1, 5)),
                         *(f"dropd{i}" for i in range(3, -1, -1)),
                         *(f"dropp_{i}" for i in range(4))]
        want = core(x, rng=_replay_map(core, rec, got))
    assert len(fused_on_cpu) == 12  # the replay took the plain path
    for key in ("logits", "y_softmax", "prob_decoder_features"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def _block(cfg=ConvConfig()):
    blk = blocks.SEResNetBottleNeck(6, 8, (1, 3, 3), (1, 1, 1), 2, cfg)
    for p in blk.parameters():
        torch.nn.init.normal_(p, 0.0, 0.4)
    return blk


FALLBACKS = {
    "no dropout handed in": dict(drop=None),
    "autograd": dict(grad=True),
    "halo sharding": dict(sharded=object()),
    "fp8 activation store": dict(cfg=ConvConfig(act_store="float8_e4m3fn")),
    "a mask-map replay": dict(rng={"drope1": torch.ones((2, 3, 8, 6, 8), dtype=torch.bool)}),
    "rate 1": dict(rate=1.0),
    "float64": dict(dtype=torch.float64),
    "a gate of another dtype": dict(gate_dtype=torch.float32, dtype=torch.bfloat16),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_fallback_conditions_take_the_plain_path(fused_on_cpu, case):
    """Each condition of ``_fused_tail`` that keeps the plain ops: the
    block launches no K8 apply (here: makes no fused call) and gives the
    plain path's output."""
    f = FALLBACKS[case]
    dtype = f.get("dtype", torch.float32)
    blk = _block(f.get("cfg", ConvConfig(dtype=dtype)))
    if "gate_dtype" in f:  # an fp32 gate over bf16 activations: x_ * s promotes
        blk.se_conv6.dtype = blk.se_conv7.dtype = f["gate_dtype"]
    if dtype == torch.float64:
        blk = blk.double()
    drop = blocks.ConfigurableDropout(f.get("rate", 0.5), "monte-carlo", "drope1")
    rng = f.get("rng", torch.Generator().manual_seed(1))
    handed = f.get("drop", (drop, False, rng))
    x = torch.randn((2, 3, 8, 6, 6)).to(dtype)
    sharded = f.get("sharded")
    residual = torch.zeros((2, 3, 8, 6, 8), dtype=dtype)
    with torch.set_grad_enabled(f.get("grad", False)):
        assert blk._fused_tail(x[..., :1].expand(2, 3, 8, 6, 8).contiguous(), residual,
                               sharded, handed) is None
        if sharded is None:
            blk(x, None, handed)
    assert fused_on_cpu == []


def test_inactive_dropout_runs_the_tail_alone(fused_on_cpu):
    """'standard' dropout at inference and rate 0 draw nothing: K8 runs its
    apply without a mask (keep 1)."""
    blk = _block()
    x = torch.randn((2, 3, 8, 6, 6))
    x_ = x[..., :1].expand(2, 3, 8, 6, 8).contiguous()
    for drop in (blocks.ConfigurableDropout(0.5, "standard", "drope1"),
                 blocks.ConfigurableDropout(0.0, "monte-carlo", "drope1")):
        with torch.no_grad():
            assert blk._fused_tail(x_, x_, None, (drop, False, None)) == 1.0
            blk(x, None, (drop, False, None))
    assert fused_on_cpu == [((2, 3, 8, 6, 8), False, 1.0)] * 2


@pytest.mark.parametrize("cfg,blocks_", [(CFG1, 8), (PROB, 12), (PROB_DENSE, 12)])
def test_served_se_shapes(cfg, blocks_):
    """The SE blocks a served forward runs K8 over (a meta forward): cfg1's
    8 (encoder 1-4, decoder 3-0), prob's and prob_dense's 12 (the ladder's
    4 besides), at widths 16-256."""
    shapes = trace_se_shapes(cfg, 2)
    assert sum(shapes.values()) == blocks_
    assert {s[-1] for s in shapes} == {16, 32, 64, 128, 256}
    assert all(s[0] == 2 for s in shapes)
    assert shapes[(2, 20, 160, 160, 16)] == 1 + (blocks_ == 12)


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _served_se_shapes(batch):
    """The SE output shapes (B, D, H, W, C) of the served models' blocks
    (cfg1's trunk, the ladders of prob and prob_dense)."""
    return sorted(set().union(*(trace_se_shapes(cfg, batch) for cfg in (CFG1, PROB, PROB_DENSE))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_apply_is_the_twin_at_served_shapes(card, dtype):
    """Given the same gate, the apply's bits are the torch chain's on the
    card (the twin there), masked at keep 0.5 and 0.75 and unmasked, at
    every served SE shape at batch 2."""
    shapes = _served_se_shapes(2)
    assert {s[-1] for s in shapes} == {16, 32, 64, 128, 256}
    for i, shape in enumerate(shapes):
        x, s, res = _operands(shape, dtype, seed=i, device=card)
        u = torch.rand(shape, generator=torch.Generator(card).manual_seed(i), device=card)
        for uu, keep in ((None, 1.0), (u, 0.5), (u, 0.75)):
            got = k8.se_tail(x, s, res, uu, keep)
            want = k8.se_tail_plain(x, s, res, uu, keep)
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"{shape} {keep}")


RAGGED = [((2, 3, 5, 7, 3), 0), ((2, 2, 3, 5, 12), 0), ((1, 3, 4, 5, 20), 0),
          ((2, 2, 4, 4, 16), 1), ((2, 1, 3, 3, 8), 3), ((3, 2, 5, 5, 40), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", RAGGED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_ragged_widths_and_unaligned_bases(card, dtype, shape, offset):
    """Widths that fill no 16-byte vector, and bases ``offset`` elements
    past a 16-byte boundary (the scalar route): the apply is the twin's
    bits, the mean within fp32 rounding of the fp32 sum's."""
    n = int(np.prod(shape))

    def at_offset(t):
        buf = torch.empty(n + offset, dtype=t.dtype, device=card)
        out = buf[offset:].view(shape)
        out.copy_(t)
        return out

    x, s, res = _operands(shape, dtype, seed=offset, device=card)
    x, res = at_offset(x), at_offset(res)
    u = at_offset(torch.rand(shape, generator=torch.Generator(card).manual_seed(0),
                             device=card))
    for uu, keep in ((None, 1.0), (u, 0.5)):
        torch.testing.assert_close(k8.se_tail(x, s, res, uu, keep),
                                   k8.se_tail_plain(x, s, res, uu, keep), rtol=0, atol=0)
    want = x.double().mean(dim=(1, 2, 3), keepdim=True)
    torch.testing.assert_close(k8.se_mean(x).double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_sums_agree_and_repeat(card, dtype):
    """The mean at every served SE shape at batch 2 (and level 4's at batch
    32) agrees with the fp32 sum over n within fp32 rounding, and a second
    run gives the same bits."""
    for i, shape in enumerate(_served_se_shapes(2) + [(32, 5, 10, 10, 256)]):
        x, _, _ = _operands(shape, dtype, seed=i, device=card)
        got = k8.se_mean(x)
        n = shape[1] * shape[2] * shape[3]
        ref = x.double().sum(dim=(1, 2, 3), keepdim=True) / n
        scale = x.double().abs().sum(dim=(1, 2, 3), keepdim=True) / n
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert bool(((got.double() - ref).abs() <= 1e-5 * scale + 1e-7).all()), shape
        assert torch.equal(got, k8.se_mean(x)), shape


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,dtype,launches", [
    ("cfg1", CFG1, torch.bfloat16, 8), ("cfg1", CFG1, torch.float32, 8),
    ("prob", PROB, torch.bfloat16, 12), ("prob_dense", PROB_DENSE, torch.bfloat16, 12)])
def test_card_launches_a_served_forward(card, name, cfg, dtype, launches):
    """One forward of a served model (MC dropout 0.5, one volume through
    ``InferenceSession``): 8 K8 applies a cfg1 forward in both dtypes, 12 a
    prob or prob_dense one (8 trunk, 4 ladder), every one masked; the output
    is finite."""
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    model = M1(**dict(cfg, dropout_mode="monte-carlo", dropout_rate=0.5), summary=False,
               seed=0, dtype=dtype, device=card)
    session = InferenceSession(model, mc_iter=1, seed=1, device=card)
    x = np.random.default_rng(0).normal(
        size=(1, *cfg["input_spatial_dims"], cfg["input_channels"])).astype(np.float32)
    if cfg.get("probabilistic"):
        x[..., -1] = 0.0
    session(x)
    n0, m0 = k8.se_tail.launches, k8.se_tail.masked
    probs = session(x)
    probs = probs[0] if isinstance(probs, tuple) else probs
    assert (k8.se_tail.launches - n0, k8.se_tail.masked - m0) == (launches, launches), name
    assert np.isfinite(np.asarray(probs)).all()
