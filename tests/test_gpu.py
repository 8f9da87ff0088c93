"""Tests that need the card: the megakernel as Triton compiled it (no
interpreter) against the plain XLA engines on the same GPU.  Marked
``gpu``; they skip elsewhere and `chip_smoke.py` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops import mega2, replay
from raytracinginoneweekendincuda_tpu.ops.backend import pallas_interpret
from raytracinginoneweekendincuda_tpu.ops.raygen import generate_rays
from raytracinginoneweekendincuda_tpu.ops.render import render
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("sid", [0, 4, 9])
def test_compiled_kernel_matches_xla(sid):
    """Same RNG draws and bounce rules: the compiled kernel's frame agrees
    with the chunked engine except on pixels an ulp-level difference
    re-rolled."""
    assert pallas_interpret() is False
    W, H = 64, 32
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4)
    ref = np.asarray(render(scene, meta, cfg))
    img = np.asarray(render(scene, meta, cfg.with_(engine="mega2")))
    assert np.isfinite(img).all()
    rerolled = (np.abs(img - ref).max(-1) > 1e-3).mean()
    assert rerolled <= 0.05, rerolled


def test_compiled_tape_matches_xla_tape():
    W, H, K = 64, 32, 8
    scene, meta = compile_scene(scenes.build_scene(0), W, H,
                                dtype=np.float32)
    pix = np.arange(W * H, dtype=np.int32)
    tape_k = np.asarray(mega2.mega2_tape(scene, meta, pix, 0, width=W,
                                         height=H, max_bounces=K,
                                         t_min=1e-3, seed=1984))
    sj = jax.tree.map(jnp.asarray, scene)
    o, d, t, pc = generate_rays(sj.camera, jnp.asarray(pix), jnp.uint32(0),
                                W, H, 1984)
    tape_x, _ = replay.generate_tape(sj, meta, o, d, t, pc, jnp.uint32(0),
                                     max_bounces=K, t_min=1e-3)
    assert (tape_k == np.asarray(tape_x)).mean() >= 0.99
