"""Parity: the port's base-chain kernels' plain versions (K1 ``blur9``,
K2 ``scale_down``, K7 ``scale_up``) and ``base_chain`` against the JAX
package's Pallas kernels in interpret mode, the octave shapes the atlas
layout assumes, and the chain op's layout, CPU route and refusals.

Tolerances: ``scale_up`` is bit-identical (one add chain and one exact
scale per output on both sides); the blurs sum 9 or 5 products of
0..255 intensities in another rounding order (the Pallas decimation is
a matmul), held to 2e-3, the bar of tests/test_pallas_sample.py's
base-chain parity test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import SiftConfig
from sfm_tpu.ops import image as jimage
from sfm_tpu.ops import pallas_pyramid as jpp
from sfm_tpu.sift import pyramid as jpyramid
from sfm_tpu_torch import interop
from sfm_tpu_torch.ops import pyramid as pyr
from sfm_tpu_torch.sift import frontend, pyramid
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
LP = tuple(float(t) for t in jimage.gaussian_kernel(4, 1.5 * 1.5))
SD = tuple(float(t) for t in jimage.gaussian_kernel(2, 0.5))
SIZES = [(97, 131), (96, 130)]


def _image(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("shape", SIZES)
def test_blur9_plain_matches_pallas_interpret(shape):
    img = _image(shape)
    ref = np.asarray(jpp.blur9(jnp.asarray(img), taps=LP, interpret=True))
    out = pyr.blur9_plain(T(img), LP).numpy()
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("shape", SIZES)
def test_scale_down_plain_matches_pallas_interpret(shape):
    img = _image(shape)
    ref = np.asarray(jpp.scale_down(jnp.asarray(img), taps=SD, interpret=True))
    out = pyr.scale_down_plain(T(img), SD).numpy()
    assert out.shape == ref.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("shape", SIZES)
def test_scale_up_plain_is_bit_identical_to_pallas_interpret(shape):
    img = _image(shape)
    ref = np.asarray(jpp.scale_up(jnp.asarray(img), interpret=True))
    out = pyr.scale_up_plain(T(img)).numpy()
    assert out.shape == (2 * shape[0], 2 * shape[1])
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.asarray(jimage.scale_up(jnp.asarray(img))))


def test_wrappers_take_the_plain_version_on_cpu():
    img = T(_image((40, 52)))
    assert torch.equal(pyr.blur9(img, LP), pyr.blur9_plain(img, LP))
    assert torch.equal(pyr.scale_down(img, SD), pyr.scale_down_plain(img, SD))
    assert torch.equal(pyr.scale_up(img), pyr.scale_up_plain(img))
    with pytest.raises(ValueError):
        pyr.blur9(img, LP[:-1])                    # even tap count


@pytest.mark.parametrize("up_scale", [False, True])
def test_base_chain_matches_pallas_base_chain(up_scale):
    cfg = SiftConfig(num_octaves=3, init_blur=1.0, up_scale=up_scale)
    img = _image((61, 83), seed=1)
    ref = [np.asarray(b) for b in
           jpyramid.base_chain_pallas(jnp.asarray(img), cfg, interpret=True)]
    out = [b.numpy()
           for b in pyramid.base_chain(T(img), interop.config_to_torch(cfg))]
    assert [b.shape for b in out] == [b.shape for b in ref]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=2e-3)


@pytest.mark.parametrize("levels", [1, 5, 9])
@pytest.mark.parametrize("shape", [(576, 720), (575, 719)])
def test_chain_layout_agrees_with_atlas_layout(shape, levels):
    """Level o is [H >> o, W >> o] (the floor at every step), each on a
    16-byte boundary of the chain's buffer, and ``atlas_layout`` puts
    the same heights and subsamplings in the atlas."""
    shapes, offsets, total = pyr.chain_layout(shape, levels)
    H, W = shape
    assert shapes == [(H >> o, W >> o) for o in range(levels)]
    assert all(off % 4 == 0 for off in offsets)
    assert [b - a for a, b in zip(offsets, offsets[1:])] == [
        -(-h * w // 32) * 32 for h, w in shapes[:-1]]
    assert total >= offsets[-1] + shapes[-1][0] * shapes[-1][1]
    atlas_offsets, subs = frontend.atlas_layout(shape, SiftConfig(num_octaves=levels))
    assert [b - a - 96 for a, b in zip(atlas_offsets, atlas_offsets[1:])] == [
        h for h, _ in shapes[:-1]]
    assert [(H // int(s), W // int(s)) for s in subs] == shapes
    # Without the prefilter the chain writes levels 1 .. L - 1 only.
    assert pyr.chain_layout(shape, levels, 1)[0] == shapes[1:]


@pytest.mark.parametrize("shape", [(193, 257), (96, 130)])
def test_base_chain_cpu_route_is_the_plain_chain(shape):
    """The op's CPU route is K1's plain version followed by K2's, bit
    for bit, and the sift-level chain passes it the package's taps."""
    img = T(_image(shape, seed=3))
    out = pyr.base_chain(img, LP, SD, 5)
    ref = [pyr.blur9_plain(img, LP)]
    for _ in range(4):
        ref.append(pyr.scale_down_plain(ref[-1], SD))
    assert [tuple(b.shape) for b in out] == pyr.chain_layout(shape, 5)[0]
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    cfg = SiftConfig(num_octaves=5, init_blur=1.5)
    for a, b in zip(pyramid.base_chain(img, cfg), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("taps,levels,match", [
    (LP[:-1], 2, "odd length"),                       # even tap count
    (tuple(jimage.gaussian_kernel(9, 4.0)), 2, "odd length"),   # 19 taps
    (LP, 7, "no 2x decimation"),                      # 40 x 52 -> 0 x 0 at level 6
])
def test_base_chain_refusals(taps, levels, match):
    img = T(_image((40, 52)))
    with pytest.raises(ValueError, match=match):
        pyr.base_chain(img, taps, SD, levels)


def test_base_chain_matches_pallas_at_an_odd_size_over_six_levels():
    cfg = SiftConfig(num_octaves=6, init_blur=1.0)
    img = _image((193, 257), seed=5)
    ref = [np.asarray(b) for b in
           jpyramid.base_chain_pallas(jnp.asarray(img), cfg, interpret=True)]
    out = [b.numpy() for b in pyramid.base_chain(T(img), interop.config_to_torch(cfg))]
    assert [b.shape for b in out] == [b.shape for b in ref] == [
        (193 >> o, 257 >> o) for o in range(6)]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_odd_size_atlas_rows_follow_the_layout():
    # 130 x 200 at 5 octaves: an odd side halves to 65 -> 32 -> 16 -> 8
    # rows in the TPU kernel; a ceil decimation (65 -> 33 -> 17 -> 9)
    # puts octaves 3 and 4 at other atlas rows than atlas_layout says.
    cfg = SiftConfig(num_octaves=5)
    img = _image((130, 200), seed=2)
    ref = jpyramid.base_chain_pallas(jnp.asarray(img), cfg, interpret=True)
    bases = pyramid.base_chain(T(img), cfg)
    assert [tuple(b.shape) for b in bases] == [tuple(b.shape) for b in ref]
    offsets, _ = frontend.atlas_layout(img.shape, cfg)
    atlas = frontend.build_atlas(bases)
    for off, b in zip(offsets, bases):
        h, w = b.shape
        assert torch.equal(atlas[off:off + h, :w], b)
    assert atlas.shape[0] == offsets[-1] + bases[-1].shape[0] + 48
    up = dataclasses.replace(cfg, up_scale=True, num_octaves=3)
    offsets, _ = frontend.atlas_layout(img.shape, up)
    bases = pyramid.base_chain(T(img), up)
    atlas = frontend.build_atlas(bases)
    assert [tuple(b.shape) for b in bases] == [(260, 400), (130, 200), (65, 100)]
    for off, b in zip(offsets, bases):
        assert torch.equal(atlas[off:off + b.shape[0], :b.shape[1]], b)
