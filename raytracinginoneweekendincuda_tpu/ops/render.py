"""Full-frame rendering: raygen -> trace -> sample average -> gamma.

Equivalent of the reference Render kernel + host driver (kernel.cu:122-154,
570-742), restructured for XLA: the frame is processed in fixed-size pixel
chunks (static shapes; one compilation covers every chunk), samples
accumulate in a `fori_loop`, and the gamma-2 sqrt epilogue matches
kernel.cu:147-152.

Pixel indexing matches the reference framebuffer: ``pix = j*W + i`` with j
counting *up from the bottom scanline* (kernel.cu:131); `render` flips rows
at the end so callers get a top-down [H,W,3] image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig
from .dispatch import trace_dispatch
from .raygen import generate_rays


@functools.partial(
    jax.jit,
    static_argnames=("meta", "width", "height", "spp", "seed", "max_bounces",
                     "t_min", "differentiable", "gamma", "n_valid", "engine"),
)
def render_chunk(
    scene: SceneArrays,
    pix: jnp.ndarray,   # [P] int32 pixel ids (bottom-up raster order)
    bvh=None,           # BvhArrays pytree when engine == "bvh"
    *,
    meta: SceneMeta,
    width: int,
    height: int,
    spp: int,
    seed: int,
    max_bounces: int,
    t_min: float,
    differentiable: bool = False,
    gamma: bool = True,
    n_valid: int | None = None,
    engine: str = "bruteforce",
):
    """Average radiance [P,3] over ``spp`` samples for one pixel chunk."""

    def sample_body(s, acc):
        o, d, time, pix_ctr = generate_rays(scene.camera, pix, s, width, height, seed)
        col = trace_dispatch(
            scene, meta, o, d, time, pix_ctr, s, engine=engine, bvh=bvh,
            max_bounces=max_bounces, t_min=t_min, differentiable=differentiable,
        )
        return acc + col

    acc = jax.lax.fori_loop(
        0, spp, sample_body, jnp.zeros((pix.shape[0], 3), scene.camera.origin.dtype),
        unroll=False,
    )
    col = acc / scene.camera.origin.dtype.type(spp)
    if gamma:
        col = jnp.sqrt(jnp.maximum(col, 0.0))  # gamma 2.0, kernel.cu:150-152
    return col


def render(
    scene: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    *,
    gamma: bool = True,
    out_u8: bool = False,
    device_out: bool = False,
) -> np.ndarray:
    """Render a full frame -> numpy [H,W,3] (top row first; float, or the
    reference's quantized uint8 when ``out_u8`` — kernel.cu:709-718 math
    runs on-device).  ``device_out`` (mega2 only) returns the flat
    on-device framebuffer; finish with `ops.mega2.mega2_host_image` — see
    `render_mega2` for the timing rationale."""
    if cfg.engine == "mega2":
        from .mega2 import render_mega2

        return render_mega2(scene, meta, cfg, gamma=gamma, out_u8=out_u8,
                            device_out=device_out)
    if cfg.engine.startswith("wavefront"):
        from .wavefront import render_wavefront

        return render_wavefront(scene, meta, cfg, gamma=gamma, out_u8=out_u8)
    W, H = cfg.width, cfg.height
    npix = W * H
    P = min(cfg.rays_per_batch, npix)
    n_chunks = -(-npix // P)

    bvh = None
    if cfg.engine == "bvh":
        from ..scene.bvh import build_scene_bvh

        bvh = build_scene_bvh(scene)
    out = np.zeros((npix, 3), np.float64)
    for c in range(n_chunks):
        start = c * P
        ids = np.arange(start, start + P, dtype=np.int32)
        valid = ids < npix
        ids = np.minimum(ids, npix - 1)
        col = render_chunk(
            scene, jnp.asarray(ids), bvh,
            meta=meta, width=W, height=H, spp=cfg.samples_per_pixel,
            seed=cfg.seed, max_bounces=cfg.max_bounces, t_min=cfg.t_min,
            differentiable=cfg.differentiable, gamma=gamma, engine=cfg.engine,
        )
        out[ids[valid]] = np.asarray(col, np.float64)[valid]
    fb = out.reshape(H, W, 3)   # row 0 = bottom scanline
    if out_u8:  # honor the quantized-uint8 contract (kernel.cu:709-718)
        fb = (256.0 * np.clip(fb, 0.0, 0.999)).astype(np.uint8)
    return fb[::-1]             # top-down image
