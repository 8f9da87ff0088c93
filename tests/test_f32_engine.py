"""f32 engine (the GPU production dtype) vs the f64 oracle.

f32 arithmetic flips measure-zero discrete events (root validity, Schlick
lottery), so individual samples can diverge completely; the bulk of pixels
must still match the f64 oracle to f32 precision (SURVEY.md §7 hard part (d):
keep the oracle in f64, run the device in f32, set tolerances accordingly).
"""

import numpy as np
import pytest

from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops.render import render
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.testing.compare import assert_images_close
from raytracinginoneweekendincuda_tpu.testing.oracle import Oracle
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig


@pytest.mark.parametrize("builder,name", [
    (scenes.book1_basic, "book1_basic"),
    (scenes.quads, "quads"),
    (scenes.cornell_box, "cornell"),
])
def test_f32_close_to_oracle(builder, name):
    W, H, spp = 32, 18, 4
    desc = builder()
    arr32, meta = compile_scene(desc, W, H, dtype=np.float32)
    arr64, _ = compile_scene(desc, W, H, dtype=np.float64)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp)
    img_e = render(arr32, meta, cfg)
    img_o = Oracle(arr64, meta, W, H, cfg.seed).render(spp)
    assert_images_close(
        img_e, img_o,
        bulk_tol=2e-3, bulk_frac=0.97, max_mean=2e-3, max_worst=0.7,
        label=name,
    )


@pytest.mark.parametrize("builder,name", [
    (scenes.book1_basic, "book1_basic"),     # moving spheres + checker
    (scenes.perlin_spheres, "perlin"),       # in-kernel lattice noise
    (scenes.earth, "earth"),                 # in-kernel image texture + UV
])
def test_mega2_f32_close_to_oracle(builder, name):
    """The megakernel vs the f64 oracle — the correctness anchor for the
    noise/image paths, whose cross-engine f32 comparisons are chaotic
    (marble sin amplification) or texel-quantized."""
    W, H, spp = 32, 18, 4
    desc = builder()
    arr32, meta = compile_scene(desc, W, H, dtype=np.float32)
    arr64, _ = compile_scene(desc, W, H, dtype=np.float64)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       engine="mega2")
    img_e = render(arr32, meta, cfg)
    img_o = Oracle(arr64, meta, W, H, cfg.seed).render(spp)
    assert_images_close(
        img_e, img_o,
        bulk_tol=2e-3, bulk_frac=0.93, max_mean=6e-3, max_worst=0.7,
        label=f"mega2-{name}",
    )
