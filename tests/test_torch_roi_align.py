"""Port parity, rotated RoIAlign: the port's gather formulation
(``ops/roi_align_rotated.py``, the plain version of the CUDA kernel) against
the JAX package's, on the RoI families ``chip_smoke.py`` holds the kernel to
on the card, at a small size: all four pyramid levels, elongated RoIs, a
giant RoI clamped to the top level, RoIs over the image edge, zero-size
padding, both ``clockwise`` values, and a small odd shape.

Tolerances: 1e-5 absolute in float32 on unit-normal features (the same
element-wise arithmetic in both frameworks; sin/cos and the summation order
differ in the last bits). Against the Pallas kernel in interpret mode: 2e-2
relative, that kernel's own tolerance (its weights are rounded to bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from orientedobjectdetection_tpu.ops.roi_align_rotated import (
    _level_of_rois as j_level_of_rois, roi_align_rotated as j_roi_align)
from orientedobjectdetection_torch.ops.roi_align_kernels import (
    roi_align_rotated_pyramid, roi_align_rotated_pyramid_plain, vector_path)
from orientedobjectdetection_torch.ops.roi_align_rotated import (
    level_of_rois, roi_align_rotated)

torch.set_num_threads(1)

SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


def pyramid(bsz, size, channels, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bsz, -(-size // s), -(-size // s), channels)
                       ).astype(np.float32) for s in (4, 8, 16, 32)]


def both(feats, rois, **kwargs):
    got = roi_align_rotated([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(rois), (7, 7), SCALES, 2, 56.0,
                            **kwargs)
    ref = j_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                      (7, 7), SCALES, 2, 56.0, **kwargs)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize('clockwise', [False, True])
@pytest.mark.parametrize('bsz,r,size,channels', [(2, 48, 256, 16),
                                                 (1, 13, 200, 5)])
def test_gather_matches_jax(bsz, r, size, channels, clockwise):
    rois = chip_smoke.seeded_rois(bsz, r, size, 5)
    feats = pyramid(bsz, size, channels, 6)
    got, ref = both(feats, rois, clockwise=clockwise)
    assert got.shape == ref.shape == (bsz, r, 7, 7, channels)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    n = max(r // 8, 1)
    assert np.abs(ref[:, :n]).max() > 0.1          # elongated RoIs pooled
    assert np.all(got[:, -n:] == 0.0)              # padding: exact zeros
    if clockwise:                                  # the flag changes values
        assert np.abs(got - both(feats, rois)[0]).max() > 0.1


def test_seeded_rois_cover_the_cases():
    """The generator shared with chip_smoke.py makes what its docstring
    says, and both packages route every RoI to the same level."""
    rois = chip_smoke.seeded_rois(2, 48, 256, 5)
    lvl = level_of_rois(torch.from_numpy(rois), 4, 56.0).numpy()
    np.testing.assert_array_equal(
        lvl, np.asarray(j_level_of_rois(jnp.asarray(rois), 4, 56.0)))
    live = rois[..., 2] > 0
    assert set(np.unique(lvl[live])) == {0, 1, 2, 3}
    assert (lvl[:, 6] == 3).all()                  # the giant RoI
    aspect = rois[..., 2] / np.maximum(rois[..., 3], 1e-3)
    assert (aspect[:, :6] > 6).all()
    outside = (rois[..., 0] < 0) | (rois[..., 0] > 256)
    assert outside[:, 7:13].all() and (~live[:, -6:]).all()


def test_masked_not_clamped():
    """A RoI hanging over the corner of a constant map pools less than the
    constant: corners outside contribute 0."""
    feats = [np.ones((1, 64 // s * 4, 64 // s * 4, 2), np.float32)
             for s in (4, 8, 16, 32)]
    rois = np.array([[[0.0, 0.0, 40.0, 40.0, 0.3],
                      [128.0, 128.0, 40.0, 40.0, 0.3]]], np.float32)
    got, ref = both(feats, rois)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got[0, 0].min() == 0.0 and got[0, 0].max() == 1.0
    np.testing.assert_allclose(got[0, 1], 1.0, atol=1e-6)


def test_bfloat16_features_round_once():
    """bfloat16 features: float32 accumulation, one rounding at the end."""
    rois = chip_smoke.seeded_rois(1, 24, 256, 7)
    feats = [torch.from_numpy(f).to(torch.bfloat16)
             for f in pyramid(1, 256, 8, 8)]
    got = roi_align_rotated(feats, torch.from_numpy(rois), (7, 7), SCALES)
    assert got.dtype == torch.bfloat16
    ref = roi_align_rotated([f.float() for f in feats],
                            torch.from_numpy(rois), (7, 7), SCALES)
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_other_bin_counts_match_jax():
    """The gather formulation is not specialized to 7x7 bins of 2x2."""
    rois = chip_smoke.seeded_rois(1, 16, 256, 9)
    feats = pyramid(1, 256, 4, 10)
    got = roi_align_rotated([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(rois), (5, 3), SCALES, 3, 40.0)
    ref = j_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                      (5, 3), SCALES, 3, 40.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    import orientedobjectdetection_tpu.ops.roi_align_pallas as rap

    real = pl.pallas_call

    def patched(*a, **k):
        k['interpret'] = True
        return real(*a, **k)

    monkeypatch.setattr(rap.pl, 'pallas_call', patched)
    return rap


def test_gather_matches_pallas_interpret(interpret_pallas):
    """The TPU kernel the CUDA kernel replaces, run in interpret mode,
    against the port's plain version."""
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(2, s, s, 64)).astype(np.float32)
             for s in (64, 32, 16, 8)]
    rois = np.zeros((2, 16, 5), np.float32)
    rois[..., 0] = rng.uniform(20, 230, (2, 16))
    rois[..., 1] = rng.uniform(20, 230, (2, 16))
    rois[..., 2] = rng.uniform(8, 180, (2, 16))
    rois[..., 3] = rng.uniform(8, 180, (2, 16))
    rois[..., 4] = rng.uniform(-1.5, 1.5, (2, 16))
    rois[0, 3, 2:4] = 0.0                       # padding RoI
    rois[0, 4] = [128, 128, 350, 350, 0.7]      # giant (top-level clamp)
    ref = np.asarray(interpret_pallas.roi_align_rotated_pallas(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), (7, 7),
        SCALES, 2, 56.0, oversize_cap=8))
    got = roi_align_rotated_pyramid_plain(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois), (7, 7),
        SCALES, 2, 56.0).numpy()
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 2e-2, rel
    assert np.abs(got[0, 3]).max() == 0.0


def test_feature_gradients_match_jax():
    """The gather formulation under autograd against ``jax.grad``."""
    rois = chip_smoke.seeded_rois(1, 24, 256, 11)
    feats = pyramid(1, 256, 6, 12)
    cot = np.random.default_rng(13).normal(
        size=(1, 24, 7, 7, 6)).astype(np.float32)
    t_feats = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = roi_align_rotated(t_feats, torch.from_numpy(rois), (7, 7), SCALES)
    (out * torch.from_numpy(cot)).sum().backward()

    def j_loss(fs):
        return (j_roi_align(fs, jnp.asarray(rois), (7, 7), SCALES)
                * cot).sum()

    ref = jax.grad(j_loss)([jnp.asarray(f) for f in feats])
    for g, r in zip(t_feats, ref):
        assert np.abs(np.asarray(r)).max() > 0
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r), atol=1e-5)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rois = torch.from_numpy(chip_smoke.seeded_rois(2, 16, 256, 14))
    feats = [torch.from_numpy(f) for f in pyramid(2, 256, 4, 15)]
    before = roi_align_rotated_pyramid.launches
    got = roi_align_rotated_pyramid(feats, rois, (7, 7), SCALES)
    assert roi_align_rotated_pyramid.launches == before == 0
    ref = roi_align_rotated(feats, rois, (7, 7), SCALES)
    assert torch.equal(got, ref)
    # RoI blocks give the values of the unblocked call
    blocked = roi_align_rotated_pyramid_plain(feats, rois, (7, 7), SCALES,
                                              roi_block=5)
    assert torch.equal(blocked, ref)
    assert not got.requires_grad
    # no gradient is dropped quietly: features that ask for one raise
    feats[1].requires_grad_()
    for fn in (roi_align_rotated_pyramid, roi_align_rotated_pyramid_plain):
        with pytest.raises(ValueError, match='gradient'):
            fn(feats, rois, (7, 7), SCALES)
        with torch.no_grad():
            assert torch.equal(fn(feats, rois, (7, 7), SCALES), ref.detach())
    feats[1].requires_grad_(False)
    empty = roi_align_rotated_pyramid(feats, rois[:, :0], (7, 7), SCALES)
    assert empty.shape == (2, 0, 7, 7, 4)


@pytest.mark.parametrize('bad', [
    dict(out_size=(5, 5)), dict(sampling_ratio=4),
    dict(spatial_scales=SCALES[:3]), dict(rois_dtype=torch.float64),
    dict(mixed_dtype=True), dict(channels_differ=True),
    dict(strided=True), dict(levels=5)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rois = torch.from_numpy(chip_smoke.seeded_rois(1, 8, 256, 16))
    feats = [torch.from_numpy(f) for f in pyramid(1, 256, 4, 17)]
    kwargs = dict(out_size=(7, 7), spatial_scales=SCALES, sampling_ratio=2)
    if 'rois_dtype' in bad:
        rois = rois.to(bad['rois_dtype'])
    elif 'mixed_dtype' in bad:
        feats[1] = feats[1].to(torch.bfloat16)
    elif 'channels_differ' in bad:
        feats[2] = feats[2][..., :3].contiguous()
    elif 'strided' in bad:
        feats[0] = feats[0].permute(0, 2, 1, 3)
    elif 'levels' in bad:
        feats = feats + feats[:1]
        kwargs['spatial_scales'] = SCALES + (1 / 64,)
    else:
        kwargs.update(bad)
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid(feats, rois, **kwargs)


@pytest.mark.parametrize('dtype,channels,vector', [
    (torch.bfloat16, 8, True), (torch.bfloat16, 256, True),
    (torch.bfloat16, 300, False), (torch.bfloat16, 12, False),
    (torch.float32, 4, True), (torch.float32, 300, True),
    (torch.float32, 6, False), (torch.float32, 1, False)])
def test_vector_path_needs_whole_16_byte_vectors(dtype, channels, vector):
    """The kernel's 16-byte path takes channels that fill whole vectors
    (8 bfloat16 or 4 float32) on 16-byte aligned levels; a level that is a
    view starting one element into its storage takes the scalar path."""
    feats = [torch.zeros((1, s, s, channels), dtype=dtype) for s in (8, 4)]
    assert all(f.data_ptr() % 16 == 0 for f in feats)
    assert vector_path(feats) is vector
    flat = torch.zeros(1 + 4 * 4 * channels, dtype=dtype)
    shifted = flat[1:].view(1, 4, 4, channels)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert vector_path([feats[0], shifted]) is False
