"""The backward of the port's kernels, run through their plain twins on the
CPU, against torch autograd of the forward twins and against ``jax.vjp`` of
the JAX package's ops:

  * K1 (a part list; strides (1,1,1), (1,2,2), (2,2,2)) and K2: data
    gradients by each other (TF's SAME Conv3DTranspose is the input
    gradient of SAME Conv3D), weight gradients by K6's twin;
  * IN + LReLU (K3 + K4 forward, K7 backward) with the fp32 (two-pass) and
    the bf16 (one-pass) statistics;
  * the data-gradient identity itself, and the data gradient at input
    extents that are not the output extents times the stride (K2's output
    cropped, ``dgrad_crop``) against ``jax.grad`` of the JAX package's
    ``conv3d`` / ``conv3d_parts``.

Tolerances: fp32, atol 2e-5 of gradients of O(1) (the repo's oracle
tolerance), relative where they grow with the summed extent; autograd of
the fp64 twins must agree to 1e-10. bf16 against JAX's bf16 vjp: JAX
rounds each product and sum to bf16 and the port once, so mean |diff| <=
1e-2 of the mean |gradient| for x and 5e-2 for the scale and bias (JAX's
bf16 sums); the port's are also held to its fp32 path at 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from prostatemr_3d_cad_cspca_tpu.ops import convolution as jconv
from prostatemr_3d_cad_cspca_tpu.ops.normalization import instance_norm as jinstance_norm
from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5
DN = ("NDHWC", "DHWIO", "NDHWC")


def _rand(rng, *shape, dtype=np.float32, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(dtype)


def _port_grads(fn, inputs, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(g))


@pytest.mark.parametrize("ks,st", [((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)),
                                   ((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))])
def test_conv3d_backward_matches_autograd_and_jax(ks, st):
    rng = np.random.default_rng(0)
    widths, cout, sp = (3, 5), 7, (4, 8, 8)
    parts = [_rand(rng, 2, *sp, c) for c in widths]
    kernel = _rand(rng, *ks, sum(widths), cout, scale=0.3)
    bias = _rand(rng, cout)
    out_sp = tuple(n // s for n, s in zip(sp, st))
    g = _rand(rng, 2, *out_sp, cout)

    def port(k, b, *ps):
        return cv.conv3d(list(ps), k, b, st)

    y, got = _port_grads(port, [kernel, bias, *parts], g)
    assert y.grad_fn is not None and "Conv3dFn" in type(y.grad_fn).__name__
    # torch autograd of the plain twin, in fp64
    _, ref = _port_grads(lambda k, b, *ps: cv.conv3d_plain(list(ps), k, b, st),
                         [a.astype(np.float64) for a in (kernel, bias, *parts)],
                         g.astype(np.float64))
    _, exact = _port_grads(port, [a.astype(np.float64) for a in (kernel, bias, *parts)],
                           g.astype(np.float64))
    for e, r in zip(exact, ref):
        np.testing.assert_allclose(e.numpy(), r.numpy(), atol=1e-10)

    def jconv(k, b, *ps):
        x = jnp.concatenate(ps, -1)
        return jax.lax.conv_general_dilated(x, k, st, "SAME", dimension_numbers=DN) + b

    _, vjp = jax.vjp(jconv, *(jnp.asarray(a) for a in (kernel, bias, *parts)))
    want = vjp(jnp.asarray(g))
    for name, a, e, w in zip(("kernel", "bias", "part0", "part1"), got, exact, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL * scale, err_msg=name)
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=ATOL * scale, err_msg=name)


@pytest.mark.parametrize("ks,st", [((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 2, 2)),
                                   ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1))])
def test_conv3d_transpose_backward_matches_autograd_and_jax(ks, st):
    rng = np.random.default_rng(1)
    cin, cout, sp = 6, 5, (2, 4, 4)
    x = _rand(rng, 2, *sp, cin)
    kernel = _rand(rng, *ks, cout, cin, scale=0.3)
    bias = _rand(rng, cout)
    g = _rand(rng, 2, *(n * s for n, s in zip(sp, st)), cout)

    def port(x_, k, b):
        return cv.conv3d_transpose(x_, k, b, st)

    y, got = _port_grads(port, [x, kernel, bias], g)
    assert "ConvTranspose3dFn" in type(y.grad_fn).__name__
    _, ref = _port_grads(lambda x_, k, b: cv.conv3d_transpose_plain(x_, k, b, st),
                         [a.astype(np.float64) for a in (x, kernel, bias)], g.astype(np.float64))
    _, exact = _port_grads(port, [a.astype(np.float64) for a in (x, kernel, bias)],
                           g.astype(np.float64))
    for e, r in zip(exact, ref):
        np.testing.assert_allclose(e.numpy(), r.numpy(), atol=1e-10)
    mod = nn.ConvTranspose(cout, ks, st, padding="SAME", transpose_kernel=True)

    def jconvt(x_, k, b):
        return mod.apply({"params": {"kernel": k, "bias": b}}, x_)

    _, vjp = jax.vjp(jconvt, *(jnp.asarray(a) for a in (x, kernel, bias)))
    for name, a, w in zip(("x", "kernel", "bias"), got, vjp(jnp.asarray(g))):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL * scale, err_msg=name)


@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("c", [1, 6])
def test_instance_norm_backward_matches_autograd_and_jax_fp32(c, lrelu):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 3, 5, 6, c, scale=2.0) + 0.5
    scale, bias = 1 + _rand(rng, c, scale=0.3), _rand(rng, c, scale=0.3)
    g = _rand(rng, *x.shape)

    def port(x_, s, b):
        return nm.instance_norm(x_, s, b, lrelu=lrelu)

    y, got = _port_grads(port, [x, scale, bias], g)
    assert "InstanceNormFn" in type(y.grad_fn).__name__
    plain = lambda x_, s, b: nm.in_apply_plain(x_, nm.in_stats_plain(x_), s, b, lrelu)  # noqa
    _, ref = _port_grads(plain, [a.astype(np.float64) for a in (x, scale, bias)],
                         g.astype(np.float64))
    _, exact = _port_grads(port, [a.astype(np.float64) for a in (x, scale, bias)],
                           g.astype(np.float64))
    for e, r in zip(exact, ref):
        np.testing.assert_allclose(e.numpy(), r.numpy(), atol=1e-10)

    def jnorm(x_, s, b):
        y_ = jinstance_norm(x_, s, b)
        return jnp.where(y_ >= 0, y_, 0.1 * y_) if lrelu else y_

    _, vjp = jax.vjp(jnorm, *(jnp.asarray(a) for a in (x, scale, bias)))
    for name, a, w in zip(("x", "scale", "bias"), got, vjp(jnp.asarray(g))):
        scale_ = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL * scale_, err_msg=name)


@pytest.mark.parametrize("lrelu", [False, True])
def test_instance_norm_backward_bf16_statistics_follow_jax(lrelu):
    """bf16 input: the one-pass statistics and the bf16-rounded affine of
    the forward; K7's twin against JAX's bf16 vjp of the same composition."""
    rng = np.random.default_rng(3)
    c = 8
    x = (_rand(rng, 2, 4, 6, 6, c, scale=2.0) + 0.5)
    scale, bias = 1 + _rand(rng, c, scale=0.3), _rand(rng, c, scale=0.3)
    g = _rand(rng, *x.shape)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y = nm.instance_norm(xt, st, bt, lrelu=lrelu)
    got = torch.autograd.grad(y, [xt, st, bt], torch.from_numpy(g).bfloat16())
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32

    def jnorm(x_, s, b):
        y_ = jinstance_norm(x_, s, b)
        return jnp.where(y_ >= 0, y_, 0.1 * y_) if lrelu else y_

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, vjp = jax.vjp(jnorm, xb, jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    # JAX sums the scale and bias gradients in bf16 (steps of 2**-8 over
    # 384 terms a channel): 5e-2 there, 1e-2 for x; the port's own fp32
    # sums are held to its fp32 path on the same (bf16-valued) input at 1e-2
    for name, a, w, tol in zip(("x", "scale", "bias"), got, want, (1e-2, 5e-2, 5e-2)):
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        assert np.abs(a - w).mean() <= tol * np.abs(w).mean(), name
    x32 = xt.detach().float().requires_grad_()
    ref = torch.autograd.grad(nm.instance_norm(x32, st, bt, lrelu=lrelu), [x32, st, bt],
                              torch.from_numpy(g).bfloat16().float())
    for name, a, r in zip(("x", "scale", "bias"), got, ref):
        assert (a.float() - r).abs().mean() <= 1e-2 * r.abs().mean(), name


@pytest.mark.parametrize("ks,st,sp", [((1, 3, 3), (1, 2, 2), (4, 8, 8)),
                                      ((3, 3, 3), (2, 2, 2), (4, 8, 6)),
                                      ((3, 3, 3), (1, 1, 1), (3, 5, 7)),
                                      ((1, 1, 1), (1, 1, 1), (2, 3, 4)),
                                      ((2, 2, 2), (2, 2, 2), (4, 4, 4))])
def test_data_gradients_are_each_others_kernels(ks, st, sp):
    """K1's input gradient is K2 of the output gradient with K1's kernel
    read as K2's; K2's is K1 of its output gradient with K2's kernel read
    as K1's DHWIO (fp64, so only the identity is tested)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_rand(rng, 2, *sp, 3, dtype=np.float64)).requires_grad_()
    k = torch.from_numpy(_rand(rng, *ks, 3, 4, dtype=np.float64))
    y = cv.conv3d_plain([x], k, None, st)
    g = torch.from_numpy(_rand(rng, *y.shape, dtype=np.float64))
    (want,) = torch.autograd.grad(y, [x], g)
    assert cv.dgrad_crop(x.shape[1:4], y.shape[1:4], ks, st) is None  # K2's whole output
    np.testing.assert_allclose(cv.conv3d_transpose(g, k, None, st).numpy(), want.numpy(),
                               atol=1e-12)
    z = torch.from_numpy(_rand(rng, 2, *y.shape[1:4], 4, dtype=np.float64)).requires_grad_()
    yt = cv.conv3d_transpose_plain(z, k, None, st)
    gt = torch.from_numpy(_rand(rng, *yt.shape, dtype=np.float64))
    (want_t,) = torch.autograd.grad(yt, [z], gt)
    np.testing.assert_allclose(cv.conv3d([gt], k, None, st).numpy(), want_t.numpy(), atol=1e-12)


@pytest.mark.parametrize("ks,st,sp,widths", [((1, 3, 3), (1, 2, 2), (5, 9, 10), (3,)),
                                             ((3, 3, 3), (2, 2, 2), (5, 5, 11), (3,)),
                                             ((3, 3, 3), (2, 2, 2), (5, 9, 10), (2, 3)),
                                             ((2, 2, 2), (2, 2, 2), (3, 5, 7), (3,)),
                                             ((1, 1, 1), (1, 2, 2), (4, 7, 9), (3,))])
def test_data_gradient_at_extents_that_are_not_output_times_stride(ks, st, sp, widths):
    """K1's input gradient where an input extent n is not its output extent
    o times the stride: K2 of the output gradient (extent o * s) cropped to
    [lo - lo', lo - lo' + n) per axis. Held to torch autograd of the fp64
    twin at 1e-10, and to jax.grad of the JAX package's conv3d (one part)
    or conv3d_parts (a part list) at the fp32 oracle tolerance."""
    rng = np.random.default_rng(6)
    cout = 4
    parts = [_rand(rng, 2, *sp, c) for c in widths]
    kernel = _rand(rng, *ks, sum(widths), cout, scale=0.3)
    bias = _rand(rng, cout)
    out_sp = tuple(-(-n // s) for n, s in zip(sp, st))
    assert any(n != o * s for n, o, s in zip(sp, out_sp, st))
    crop = cv.dgrad_crop(sp, out_sp, ks, st)
    assert crop is not None and all(c.stop - c.start == n for c, n in zip(crop, sp))
    g = _rand(rng, 2, *out_sp, cout)

    def port(k, b, *ps):
        return cv.conv3d(list(ps), k, b, st)

    y, got = _port_grads(port, [kernel, bias, *parts], g)
    assert tuple(y.shape) == (2, *out_sp, cout)
    _, exact = _port_grads(port, [a.astype(np.float64) for a in (kernel, bias, *parts)],
                           g.astype(np.float64))
    _, ref = _port_grads(lambda k, b, *ps: cv.conv3d_plain(list(ps), k, b, st),
                         [a.astype(np.float64) for a in (kernel, bias, *parts)],
                         g.astype(np.float64))
    for e, r in zip(exact, ref):
        np.testing.assert_allclose(e.numpy(), r.numpy(), atol=1e-10)
    mod = (jconv.conv3d(jconv.ConvConfig(), cout, ks, st) if len(widths) == 1
           else jconv.conv3d_parts(jconv.ConvConfig(), cout, ks, st))

    def loss(k, b, *ps):
        x = ps[0] if len(ps) == 1 else list(ps)
        return jnp.sum(mod.apply({"params": {"kernel": k, "bias": b}}, x) * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(2 + len(parts))))(
        *(jnp.asarray(a) for a in (kernel, bias, *parts)))
    for name, a, w in zip(("kernel", "bias", "part0", "part1"), got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL * scale, err_msg=name)


@pytest.mark.parametrize("ashape,ks,st,cb", [((2, 4, 8, 8, 3), (1, 3, 3), (1, 2, 2), 5),
                                             ((1, 3, 5, 7, 2), (3, 3, 3), (1, 1, 1), 1),
                                             ((2, 4, 6, 6, 4), (3, 3, 3), (2, 2, 2), 3)])
def test_wgrad_twin_is_the_weight_gradient_and_its_plan_covers_the_rows(ashape, ks, st, cb):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_rand(rng, *ashape, dtype=np.float64))
    k = torch.from_numpy(_rand(rng, *ks, ashape[-1], cb, dtype=np.float64)).requires_grad_()
    y = cv.conv3d_plain([a], k, None, st)
    g = torch.from_numpy(_rand(rng, *y.shape, dtype=np.float64))
    (want,) = torch.autograd.grad(y, [k], g)
    got = cv.conv3d_wgrad(a, g, ks, st)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-11)
    m, rows = int(np.prod(ks)) * ashape[-1], ashape[0] * int(np.prod(y.shape[1:4]))
    plan = cv.wgrad_plan(tuple(ashape), cb, ks, st, torch.float32)
    # the boxes hold every output voxel; the splits walk them, one box at least each
    assert plan["nbox"] * cv.WGRAD_BOX >= rows and 1 <= plan["splits"] <= plan["nbox"]
    parts = plan["splits"] * (2 if plan["pingpong"] else 1)  # one partial a warpgroup's walk
    assert plan["workspace"] == (parts * m * cb if parts > 1 else 0)
    with pytest.raises(ValueError, match="SAME output"):
        cv.conv3d_wgrad(a, g[:, :1], ks, st)


# K6's cfg1 shapes by (taps x CA, CB, batch-2 rows): A's shape, kernel, strides
WGRAD_CFG1 = {(144, 4, 1_024_000): ((2, 20, 160, 160, 16), (1, 3, 3), (1, 1, 1)),
              (144, 16, 1_024_000): ((2, 20, 160, 160, 16), (1, 3, 3), (1, 1, 1)),
              (3456, 256, 1000): ((2, 10, 20, 20, 128), (3, 3, 3), (2, 2, 2)),
              (27, 16, 1_024_000): ((2, 20, 160, 160, 3), (1, 3, 3), (1, 1, 1)),
              (1728, 64, 64_000): ((2, 20, 40, 40, 64), (3, 3, 3), (1, 1, 1))}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,cout,rows,want", [
    # level 0, batch 2: all nine taps of a 16-channel slab in one block,
    # 8000 boxes of 1x8x16 voxels over the card; (tile n, slab, taps a block)
    (144, 4, 1_024_000, {torch.bfloat16: (8, 16, 9), torch.float32: (8, 16, 9)}),
    (144, 16, 1_024_000, {torch.bfloat16: (16, 16, 9), torch.float32: (16, 16, 9)}),
    # the deepest K2: 3456 x 256 over 1000 rows; every tap in a block of 8
    # channels
    (3456, 256, 1000, {torch.bfloat16: (64, 8, 27), torch.float32: (16, 8, 27)}),
    # the stem (3 channels): the staged route's slab of 8
    (27, 16, 1_024_000, {torch.bfloat16: (16, 8, 9), torch.float32: (16, 8, 9)}),
    (1728, 64, 64_000, {torch.bfloat16: (64, 32, 7), torch.float32: (32, 16, 7)})])
def test_wgrad_plan_at_cfg1_shapes(m, cout, rows, want, dtype):
    ashape, ks, st = WGRAD_CFG1[(m, cout, rows)]
    plan = cv.wgrad_plan(ashape, cout, ks, st, dtype)
    assert plan["m"] == m and plan["nbox"] * cv.WGRAD_BOX >= rows
    assert (plan["bn"], plan["width"], plan["tpb"]) == want[dtype]


def test_no_grad_takes_the_forward_alone():
    """Serving: without grad nothing is saved and no autograd node forms."""
    x = torch.randn(1, 2, 4, 4, 3)
    k = torch.randn(1, 3, 3, 3, 4, requires_grad=True)
    s, b = torch.ones(3, requires_grad=True), torch.zeros(3, requires_grad=True)
    with torch.no_grad():
        assert cv.conv3d([x], k).grad_fn is None
        assert nm.instance_norm(x, s, b, lrelu=True).grad_fn is None
    assert cv.conv3d([x], k).grad_fn is not None
