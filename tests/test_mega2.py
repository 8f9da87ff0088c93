"""Pixel-per-lane megakernel (mega2) vs the chunked engine (Pallas
interpreter on CPU), and the kernel wrapper's shapes and offsets.

Contract: identical RNG counters and bounce-loop semantics; per-sample
radiance bit-comparable except where compiler fusion differences flip an
f32 winner tie or re-roll a Monte-Carlo branch (the in-kernel refill raygen
compiles in a different fusion context than XLA's generate_rays, so rays
can differ at 1 ulp — isolated pixels re-roll their paths).  Scenes without
that sensitivity (quads, cornell variants) are bit-exact at test size;
scene 0 (moving spheres + defocus lens) allows isolated flips.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from raytracinginoneweekendincuda_tpu.core.camera import Camera
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops import mega2
from raytracinginoneweekendincuda_tpu.ops.render import render
from raytracinginoneweekendincuda_tpu.scene.api import (
    Lambertian, SceneDesc, Sphere,
)
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig


@pytest.mark.parametrize("scene_id,max_bad", [
    (0, 6),   # moving spheres + lens: f32 tie/re-roll flips allowed
    (1, 2),   # checker spheres
    (4, 0),   # quads
    (6, 0),   # cornell (emissive, black background)
    (7, 0),   # cornell + rotated boxes
    (8, 0),   # cornell smoke (sphere+box media)
])
def test_mega2_matches_chunked(scene_id, max_bad):
    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.build_scene(scene_id), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       rays_per_batch=512)
    ref = render(scene, meta, cfg)
    img = render(scene, meta, cfg.with_(engine="mega2"))
    diff = np.abs(img - ref)
    nbad = int((diff.max(-1) > 1e-5).sum())
    assert nbad <= max_bad, f"{nbad} pixels flipped (max {diff.max():.2e})"
    # flips must be isolated Monte-Carlo re-rolls, not systematic error
    assert diff.mean() < 5e-3


@pytest.mark.parametrize("scene_id", [2, 3, 5, 9])
def test_mega2_noise_image_scenes(scene_id):
    """Perlin-noise and image-texture scenes run IN the megakernel.  Marble
    radiance is chaotically sensitive
    to ulp-level t differences on the r=1000 ground sphere (sin(scale*z +
    10*turb)), so noise scenes get a statistical bound rather than
    bit-equality; the earth scene's nearest-texel lookups tolerate isolated
    texel flips."""
    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.build_scene(scene_id), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       rays_per_batch=512)
    ref = render(scene, meta, cfg)
    img = render(scene, meta, cfg.with_(engine="mega2"))
    diff = np.abs(img - ref)
    frac_close = (diff.max(-1) < 1e-2).mean()
    assert frac_close > 0.9, f"only {frac_close:.2%} pixels close " \
                             f"(max {diff.max():.3f}, mean {diff.mean():.4f})"
    assert diff.mean() < 2e-2


def test_forced_cull_path_bit_identical():
    """Chunk culling (block-level AABB conds) engages only above
    CULL_MIN_PRIMS — no reference scene does — but it must stay correct
    for larger worlds.  Force it on for a tiny scene-9 render and require
    the image BIT-IDENTICAL to the default render: conservative skips
    cannot change the winner (AABB.h:68-98 argument)."""
    from raytracinginoneweekendincuda_tpu.ops.mega2 import render_mega2

    scene, meta = compile_scene(scenes.build_scene(9), 16, 8,
                                dtype=np.float32)
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2,
                       max_bounces=6, engine="mega2")
    ref = render_mega2(scene, meta, cfg, cull=False)
    img = render_mega2(scene, meta, cfg, cull=True)
    np.testing.assert_array_equal(img, ref)


def _pad_lanes(n):
    return -(-n // mega2.LANES) * mega2.LANES


def test_block_and_tile_shapes_are_powers_of_two():
    """Triton tensors need power-of-two shapes: the lane block, the pair
    tile and the chunk, with whole tiles per chunk and one lane per
    thread."""
    for v in (mega2.LANES, mega2.PAIR_C, mega2.CHUNK):
        assert v > 0 and v & (v - 1) == 0, v
    assert mega2.CHUNK % mega2.PAIR_C == 0
    assert mega2.LANES == 32 * mega2.NUM_WARPS


@pytest.mark.parametrize("sid", [0, 9])
def test_tables_padded_to_whole_chunks(sid):
    """Every table a tile reads spans whole chunks, so no tile load runs
    past its table (Triton loads are unchecked)."""
    scene, meta = compile_scene(scenes.build_scene(sid), 16, 8,
                                dtype=np.float32)
    tabs, lay, _med, remap = mega2.pack_mega2_tables(scene, meta)
    assert tabs.sph.shape[1] == lay.s_pad and lay.s_pad % mega2.CHUNK == 0
    assert tabs.quad.shape[1] >= max(lay.nl_pad, mega2.CHUNK)
    assert tabs.box.shape[1] >= max(lay.b_pad, mega2.CHUNK)
    assert tabs.cull.shape[1] == lay.pair_rows // mega2.CHUNK
    assert tabs.attr.shape[0] == (lay.n_geo + 1) * mega2.ATTR_COLS
    assert remap.shape[0] == lay.n_geo + max(meta.n_media, 1)


def test_padding_rows_never_win():
    """Sphere padding rows carry rad^2 = -1, so disc = b^2 - a(|oc|^2 + 1)
    < 0 for ANY ray — including rays through the padding rows' (0,0,0)
    centre, where rad^2 = 0 used to admit a phantom sphere.  A camera
    looking straight through the origin must never report a padding row
    as a winner."""
    desc = SceneDesc()
    desc.add(Sphere((0.0, 0.0, -5.0), 0.5, Lambertian((0.5, 0.5, 0.5))))
    desc.camera = Camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=30.0,
                         background=(0.7, 0.8, 1.0))
    W, H = 16, 8
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    tabs, lay, _med, remap = mega2.pack_mega2_tables(scene, meta)
    sph = np.asarray(tabs.sph)
    assert (sph[10, 1:] == -1.0).all() and sph[10, 0] == np.float32(0.25)
    tape = np.asarray(mega2.mega2_tapes(scene, meta, np.arange(W * H), 2,
                                        width=W, height=H, max_bounces=3,
                                        t_min=1e-3, seed=1984,
                                        id_space="kernel"))
    assert set(np.unique(tape)) <= {-1, 0}
    assert (tape == 0).any()


def test_lane_padding_when_npix_not_a_block_multiple():
    """A frame whose pixel count is not a LANES multiple pads with -1
    lanes; they trace nothing and the frame matches the chunked engine."""
    W, H = 13, 7
    assert (W * H) % mega2.LANES != 0
    scene, meta = compile_scene(scenes.quads(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2)
    ref = render(scene, meta, cfg)
    img = render(scene, meta, cfg.with_(engine="mega2"))
    np.testing.assert_array_equal(img, ref)
    tabs, lay, med, _ = mega2.mega2_tables(scene, meta)
    spec = mega2.kernel_spec(scene, meta, lay, med, seed=cfg.seed,
                             max_bounces=cfg.max_bounces, t_min=cfg.t_min)
    N = _pad_lanes(W * H)
    pix = np.where(np.arange(N) < W * H, np.arange(N), -1).astype(np.int32)
    sums, segs = mega2.render_lanes(spec, tabs, jnp.asarray(pix), spp=2,
                                    width=W, height=H, interpret=True)
    sums, segs = np.asarray(sums), np.asarray(segs)
    assert (segs[W * H:] == 0).all() and (sums[:, W * H:] == 0).all()
    assert (segs[:W * H] >= 2).all()


def test_samp0_and_stride_offsets():
    """A lane set with a sample base and a pixel stride (the mesh shard
    layout) draws exactly the global (pixel, sample) streams: two sample
    halves of strided pixels sum to the one-shot render of those pixels."""
    W, H, spp = 16, 8, 4
    scene, meta = compile_scene(scenes.build_scene(0), W, H,
                                dtype=np.float32)
    tabs, lay, med, _ = mega2.mega2_tables(scene, meta)
    spec = mega2.kernel_spec(scene, meta, lay, med, seed=1984,
                             max_bounces=8, t_min=1e-3)
    kw = dict(width=W, height=H, interpret=True)
    stride = 3
    ids = 1 + stride * np.arange(_pad_lanes((W * H) // stride))
    pix = jnp.asarray(np.where(ids < W * H, ids, -1).astype(np.int32))
    full, _ = mega2.render_lanes(spec, tabs, pix, spp=spp, **kw)
    lo, _ = mega2.render_lanes(spec, tabs, pix, spp=2, samp0=0, **kw)
    hi, _ = mega2.render_lanes(spec, tabs, pix, spp=2, samp0=2, **kw)
    np.testing.assert_allclose(np.asarray(lo) + np.asarray(hi),
                               np.asarray(full), rtol=2e-6, atol=2e-6)
    # and the strided lanes match the whole-frame render's pixels
    frame = np.asarray(mega2.render_mega2(
        scene, meta, RenderConfig(width=W, height=H, samples_per_pixel=spp,
                                  max_bounces=8), gamma=False))
    frame = frame[::-1].reshape(-1, 3)
    live = np.asarray(pix) >= 0
    np.testing.assert_allclose(np.asarray(full).T[live] / spp,
                               frame[np.asarray(pix)[live]], rtol=1e-6,
                               atol=1e-7)
