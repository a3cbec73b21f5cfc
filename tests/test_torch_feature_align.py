"""Port parity, the refine detectors' building blocks: the bilinear sampling
of ``ops/feature_align.py`` (values and the gradient into the features),
``ORConv2d`` and ``rotation_invariant_pooling``, and
``PseudoAnchorGenerator.valid_flags``, against the JAX package on
numpy-seeded inputs.

The port's features are NCHW and its samples (B, C, N); the JAX package's
are NHWC and (B, N, C). Points lie off every edge of the map, on it, and
on levels of 1x1 and 2x2 cells. Tolerances are stated at each
comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orientedobjectdetection_tpu.core.anchors import \
    PseudoAnchorGenerator as JPseudo
from orientedobjectdetection_tpu.models import utils_rotation as j_rot
from orientedobjectdetection_tpu.ops import feature_align as j_fa
from orientedobjectdetection_torch.core import PseudoAnchorGenerator
from orientedobjectdetection_torch.models import utils_rotation as rot
from orientedobjectdetection_torch.ops import feature_align as fa

torch.set_num_threads(1)

# (H, W): a level of many cells, odd sizes, and the 2x2 / 1x1 levels that
# the stride-128 level is at 256^2 / smaller
SHAPES = [(9, 13), (2, 2), (1, 1), (1, 3)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def edge_points(rng, h, w, b=2, n=64):
    """Points inside the map, on its cell centres and edges, and off every
    edge by up to 2.5 cells (corners included)."""
    px = rng.uniform(-2.5, w + 1.5, (b, n))
    py = rng.uniform(-2.5, h + 1.5, (b, n))
    px[:, :8] = [-1.0, -0.5, 0.0, w - 1, w - 0.5, w, -1e-3, w - 1 + 1e-3]
    py[:, :8] = [0.5, -1.0, h - 1, -0.5, h, 0.0, h - 0.999, -2.0]
    px[:, 8:12] = np.floor(px[:, 8:12])            # integer coordinates
    return px.astype(np.float32), py.astype(np.float32)


def check_close(got, ref, scale, err_msg=''):
    """|port - JAX| <= 1e-5 x the feature range."""
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                               err_msg=err_msg)


def feature_vjp(j_fn, t_fn, feat, args_j, args_t, rng):
    """Values and the gradient into the features of a sampling function, a
    random cotangent, in both packages (the port's output made NHWC-like
    by ``t_fn``)."""
    feat_t = nchw(feat).requires_grad_(True)
    out_t = t_fn(feat_t, *args_t)
    cot = rng.normal(0, 1, out_t.shape).astype(np.float32)
    (out_t * torch.from_numpy(cot)).sum().backward()
    out_j, vjp = jax.vjp(lambda f: j_fn(f, *args_j), jnp.asarray(feat))
    return out_t.detach().numpy(), out_j, feat_t.grad, vjp, cot


@pytest.mark.parametrize('h, w', SHAPES)
def test_bilinear_sample_matches_jax(h, w):
    rng = np.random.default_rng(h * 31 + w)
    feat = rng.normal(0, 3, (2, h, w, 5)).astype(np.float32)
    px, py = edge_points(rng, h, w)
    got, ref, grad, vjp, cot = feature_vjp(
        j_fa.bilinear_sample,
        lambda f, x, y: fa.bilinear_sample(f, x, y).transpose(1, 2),
        feat, (jnp.asarray(px), jnp.asarray(py)),
        (torch.from_numpy(px), torch.from_numpy(py)), rng)
    scale = np.abs(feat).max()
    check_close(got, np.asarray(ref), scale)
    assert (np.abs(got[:, :8]) > 0).any() and (got == 0).any()
    (ref_grad,) = vjp(jnp.asarray(cot))
    check_close(grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_grad),
                np.abs(np.asarray(ref_grad)).max(), 'feature gradient')
    assert fa.bilinear_sample(nchw(feat).bfloat16(), torch.from_numpy(px),
                              torch.from_numpy(py)).dtype == torch.float32


def random_boxes(rng, b, n, h, w, stride, far=0.2):
    """(B, N, 5) boxes in image coordinates around an h x w map of
    ``stride``, a ``far`` share of them centred well off the image."""
    cx = rng.uniform(-stride, (w + 1) * stride, (b, n))
    cy = rng.uniform(-stride, (h + 1) * stride, (b, n))
    off = rng.random((b, n)) < far
    cx[off] += rng.choice([-1, 1], off.sum()) * 5 * w * stride
    return np.stack([cx, cy, rng.uniform(0.5, 6, (b, n)) * stride,
                     rng.uniform(0.5, 6, (b, n)) * stride,
                     rng.uniform(-np.pi, np.pi, (b, n))],
                    -1).astype(np.float32)


@pytest.mark.parametrize('points', [1, 5])
@pytest.mark.parametrize('h, w', SHAPES)
def test_rotated_feature_align_matches_jax(h, w, points):
    rng = np.random.default_rng(h * 7 + w + points)
    stride = 16
    feat = rng.normal(0, 2, (2, h, w, 6)).astype(np.float32)
    rois = random_boxes(rng, 2, h * w, h, w, stride)
    got, ref, grad, vjp, cot = feature_vjp(
        lambda f, r: j_fa.rotated_feature_align(f, r, 1.0 / stride, points),
        lambda f, r: fa.rotated_feature_align(
            f, r, 1.0 / stride, points).permute(0, 2, 3, 1),
        feat, (jnp.asarray(rois),), (torch.from_numpy(rois),), rng)
    scale = np.abs(feat).max()
    check_close(got, np.asarray(ref), scale)
    (ref_grad,) = vjp(jnp.asarray(cot))
    check_close(grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_grad),
                np.abs(np.asarray(ref_grad)).max(), 'feature gradient')


@pytest.mark.parametrize('h, w', SHAPES)
def test_align_conv_sample_matches_jax(h, w):
    """Taps in ``meshgrid(idx, idx, 'ij')`` order, ``cx / stride`` with no
    half-cell shift."""
    rng = np.random.default_rng(h * 11 + w)
    stride = 8
    feat = rng.normal(0, 2, (2, h, w, 4)).astype(np.float32)
    anchors = random_boxes(rng, 2, h * w, h, w, stride)
    got, ref, grad, vjp, cot = feature_vjp(
        lambda f, a: j_fa.align_conv_sample(f, a, float(stride), 3),
        lambda f, a: fa.align_conv_sample(
            f, a, float(stride), 3).permute(0, 3, 4, 2, 1),
        feat, (jnp.asarray(anchors),), (torch.from_numpy(anchors),), rng)
    check_close(got, np.asarray(ref), np.abs(feat).max())
    (ref_grad,) = vjp(jnp.asarray(cot))
    check_close(grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_grad),
                np.abs(np.asarray(ref_grad)).max(), 'feature gradient')


def test_align_conv_tap_order():
    """An axis-aligned anchor of 3 x 3 cells: tap ``t = (dy + 1) * 3 +
    (dx + 1)`` reads cell ``(y + dy, x + dx)``."""
    h = w = 5
    feat = torch.arange(h * w, dtype=torch.float32).reshape(1, 1, h, w)
    anchors = torch.zeros(1, h * w, 5)
    anchors[0, 12] = torch.tensor([2 * 4.0, 2 * 4.0, 3 * 4.0, 3 * 4.0, 0])
    taps = fa.align_conv_sample(feat, anchors, 4.0, 3)[0, 0, :, 2, 2]
    expect = [(2 + dy) * w + (2 + dx) for dy in (-1, 0, 1)
              for dx in (-1, 0, 1)]
    assert taps.tolist() == expect


@pytest.mark.parametrize('h, w', SHAPES)
def test_deform_conv_sample_matches_jax(h, w):
    """Offsets in mmcv's DCN order: channel ``2t`` dy, ``2t + 1`` dx."""
    rng = np.random.default_rng(h * 13 + w)
    feat = rng.normal(0, 2, (2, h, w, 3)).astype(np.float32)
    offsets = rng.normal(0, 1.5, (2, h, w, 18)).astype(np.float32)
    got, ref, grad, vjp, cot = feature_vjp(
        lambda f, o: j_fa.deform_conv_sample(f, o, 3),
        lambda f, o: fa.deform_conv_sample(f, o, 3).permute(0, 3, 4, 2, 1),
        feat, (jnp.asarray(offsets),), (nchw(offsets),), rng)
    check_close(got, np.asarray(ref), np.abs(feat).max())
    (ref_grad,) = vjp(jnp.asarray(cot))
    check_close(grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_grad),
                np.abs(np.asarray(ref_grad)).max(), 'feature gradient')


# ---- ORConv2d and rotation-invariant pooling -------------------------------
def test_rotation_perms_match_jax():
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(rot._rotation_perms(n),
                                      j_rot._rotation_perms(n))


def to_jax_orconv(weight):
    """mmcv's (out, in, nOr, 3, 3) -> the JAX package's (9, in, nOr, out)
    (``convert_orconv``)."""
    o, i, n = weight.shape[:3]
    return np.transpose(weight, (3, 4, 1, 2, 0)).reshape(9, i, n, o)


@pytest.mark.parametrize('in_orientations', [1, 8])
def test_orconv_matches_jax(in_orientations):
    """Outputs within 1e-5 relative of their largest, and the gradients
    into the input and the weight likewise."""
    rng = np.random.default_rng(in_orientations)
    cin, cout = 3, 4
    x = rng.normal(0, 1, (2, 6, 7, cin * in_orientations)).astype(np.float32)
    conv = rot.ORConv2d(cin, cout, in_orientations=in_orientations)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.normal(
            0, 0.3, tuple(conv.weight.shape)).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.normal(
            0, 0.1, conv.bias.shape).astype(np.float32)))
    x_t = nchw(x).requires_grad_(True)
    out = conv(x_t)
    assert out.shape == (2, cout * 8, 6, 7)
    cot = rng.normal(0, 1, out.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()

    jconv = j_rot.ORConv2d(cout, in_orientations=in_orientations)
    params = {'kernel': jnp.asarray(to_jax_orconv(conv.weight.detach()
                                                  .numpy())),
              'bias': jnp.asarray(conv.bias.detach().numpy())}
    ref, vjp = jax.vjp(lambda p, xx: jconv.apply({'params': p}, xx), params,
                       jnp.asarray(x))
    ref = np.asarray(ref)
    got = out.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    g_params, g_x = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    g_x = np.asarray(g_x)
    np.testing.assert_allclose(x_t.grad.permute(0, 2, 3, 1).numpy(), g_x,
                               rtol=0, atol=1e-5 * np.abs(g_x).max())
    g_w = np.asarray(g_params['kernel'])
    np.testing.assert_allclose(to_jax_orconv(conv.weight.grad.numpy()), g_w,
                               rtol=0, atol=1e-5 * np.abs(g_w).max())


def test_orconv_rotates_the_filter():
    """Copy ``o`` of a filter that reads only its top-left tap reads the
    tap ``o`` ring steps clockwise; the ReDet options raise naming A.9."""
    conv = rot.ORConv2d(1, 1)
    with torch.no_grad():
        conv.weight.zero_()
        conv.weight[0, 0, 0, 0, 0] = 1.0
    w = conv.rotated_weight().reshape(8, 9)
    ring = [0, 1, 2, 5, 8, 7, 6, 3]
    for o in range(8):
        assert w[o].nonzero().flatten().tolist() == [ring[o]]
    for kw in (dict(interp=True), dict(steerable=True)):
        with pytest.raises(NotImplementedError, match='ROADMAP A.9'):
            rot.ORConv2d(1, 1, **kw)


def test_rotation_invariant_pooling_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 4, 5, 24)).astype(np.float32)
    x[0, 0, 0, :8] = 1.5                       # a tie: the gradient splits
    x_t = nchw(x).requires_grad_(True)
    out = rot.rotation_invariant_pooling(x_t, 8)
    cot = rng.normal(0, 1, out.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    ref, vjp = jax.vjp(lambda v: j_rot.rotation_invariant_pooling(v, 8),
                       jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    (g,) = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(x_t.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(g), rtol=1e-6, atol=1e-7)


# ---- PseudoAnchorGenerator -----------------------------------------------
@pytest.mark.parametrize('pad_shape', [(128, 128), (100, 60), (8, 200)])
def test_pseudo_anchor_valid_flags_match_jax(pad_shape):
    strides = [8, 16, 32, 64, 128]
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    gen, ref = PseudoAnchorGenerator(strides), JPseudo(strides)
    assert gen.num_base_anchors == ref.num_base_anchors == [1] * 5
    assert gen.num_levels == 5
    for got, want in zip(gen.valid_flags(sizes, pad_shape),
                         ref.valid_flags(sizes, pad_shape)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
