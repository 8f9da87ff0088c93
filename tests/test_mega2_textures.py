"""Megakernel texture coverage vs the chunked engine: several images,
several Perlin tables and an image texture on a quad, all in-kernel —
packed texels with one indexed load per image, one turbulence pass per
noise table (winner-selected), and the quad (alpha,beta) UV frame in attr
cols 32:40 (Quad.h:89-99 + Texture.h:117-127).  Each scene must match the
chunked engine (Pallas interpreter on CPU, same tolerance discipline as
tests/test_mega2.py).
"""

import numpy as np
import pytest

from raytracinginoneweekendincuda_tpu.core.camera import Camera
from raytracinginoneweekendincuda_tpu.ops.mega2 import pack_mega2_tables
from raytracinginoneweekendincuda_tpu.ops.render import render
from raytracinginoneweekendincuda_tpu.scene.api import (
    Box, DiffuseLight, ImageTexture, Lambertian, NoiseTexture, Quad,
    SceneDesc, Sphere,
)
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

SKY = (0.70, 0.80, 1.00)


def _bytes(img):
    """Quantize to the byte grid: the reference image pipeline stores
    BYTES (RtwImage.h:64-68) and so does mega2's packed texels; float
    engines sample img_data directly, so test images must be k/255."""
    return np.round(img * 255.0) / 255.0


def _img_a():
    """Deterministic 12x20 RGB ramp (distinct per channel)."""
    h, w = 12, 20
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / (w - 1), y / (h - 1), (x + y) / (w + h - 2)], -1)
    return _bytes(np.ascontiguousarray(img))


def _img_b():
    """Deterministic 9x14 checker-ish image with different dims."""
    h, w = 9, 14
    y, x = np.mgrid[0:h, 0:w]
    c = ((x // 3 + y // 3) % 2).astype(np.float64)
    return _bytes(np.ascontiguousarray(np.stack([c, 1.0 - c, 0.5 * c], -1)))


def _compare(desc, max_bad=0, spp=2):
    W, H = 16, 8
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       rays_per_batch=512)
    ref = render(scene, meta, cfg)                       # chunked engine
    img = render(scene, meta, cfg.with_(engine="mega2"))
    diff = np.abs(img - ref)
    nbad = int((diff.max(-1) > 1e-5).sum())
    assert nbad <= max_bad, f"{nbad} pixels differ (max {diff.max():.2e})"
    assert diff.mean() < 5e-3
    return scene, meta


def test_two_images_and_image_on_quad():
    """Two distinct images (different dims) on spheres plus an image on a
    quad — the quad UV must be its interior (alpha,beta)."""
    desc = SceneDesc()
    desc.add(
        Sphere((-2.2, 0, 0), 1.0, Lambertian(ImageTexture(_img_a()))),
        Sphere((2.2, 0, 0), 1.0, Lambertian(ImageTexture(_img_b()))),
        Quad((-2, -2, -2), (4, 0, 0), (0, 4, 0),
             Lambertian(ImageTexture(_img_a()))),
    )
    desc.camera = Camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=40.0,
                         background=SKY)
    scene, meta = _compare(desc)
    # two _img_a() calls create distinct arrays: 3 packed images total
    assert meta.n_images == 3 and meta.image_on_quad


def test_two_noise_tables():
    """Two Perlin tables with different seeds: winners must select their
    own table's turbulence."""
    desc = SceneDesc()
    desc.add(
        Sphere((0, -1000, 0), 1000.0,
               Lambertian(NoiseTexture(4.0, table_seed=0))),
        Sphere((0, 2, 0), 2.0, Lambertian(NoiseTexture(2.0, table_seed=7))),
    )
    desc.camera = Camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=20.0,
                         background=SKY)
    # marble is ulp-sensitive on the r=1000 ground: statistical bound,
    # same discipline as tests/test_mega2.py noise scenes
    W, H = 16, 8
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    assert meta.n_noise == 2
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2,
                       rays_per_batch=512)
    ref = render(scene, meta, cfg)
    img = render(scene, meta, cfg.with_(engine="mega2"))
    diff = np.abs(img - ref)
    frac_close = (diff.max(-1) < 1e-2).mean()
    assert frac_close > 0.9, f"only {frac_close:.2%} close " \
                             f"(max {diff.max():.3f})"
    assert diff.mean() < 2e-2


def test_image_on_box_face():
    """Axis-aligned box with image-textured faces: the box fast path no
    longer excludes them (winners report face-quad rows whose attr rows
    carry the UV frame)."""
    desc = SceneDesc()
    desc.add(
        Box((-1, -1, -1), (1, 1, 1), Lambertian(ImageTexture(_img_a()))),
        Quad((-3, -3, -3), (6, 0, 0), (0, 0, 6),
             Lambertian((0.5, 0.5, 0.5))),
        Sphere((0, 5, 2), 1.0, DiffuseLight((4.0, 4.0, 4.0))),
    )
    desc.camera = Camera(lookfrom=(4, 3, 6), lookat=(0, 0, 0), vfov=40.0,
                         background=SKY)
    scene, meta = _compare(desc)
    # the box group must actually be detected (image faces included)
    layout = pack_mega2_tables(scene, meta)[1]
    assert layout.b_pad > 0, "box slab rows missing: detection regressed"


def test_box_detection_pinned():
    """The box fast path is an exact pattern match on the compiler's
    `_box_quads` face layout; a compiler reorder would silently de-box
    scene 9 (a 2x perf cliff with no image change).  Pin it: scene 9's
    400 ground boxes detect; scenes 7/8 (RotateY'd MakeBox) detect zero
    and stay on the quad pair path.  Ref: Instance.h:166-184."""
    from raytracinginoneweekendincuda_tpu.models import scenes
    from raytracinginoneweekendincuda_tpu.ops.mega2 import CHUNK

    sc9, meta9 = compile_scene(scenes.build_scene(9), 16, 8,
                               dtype=np.float32)
    b_pad = pack_mega2_tables(sc9, meta9)[1].b_pad
    expect = -(-400 // CHUNK) * CHUNK       # 400 boxes, kernel.cu:443-455
    assert b_pad == expect, f"scene 9 box rows {b_pad} != {expect}"

    for sid in (7, 8):
        sc, meta = compile_scene(scenes.build_scene(sid), 16, 8,
                                 dtype=np.float32)
        assert pack_mega2_tables(sc, meta)[1].b_pad == 0
