"""Persistent-wavefront render engine — an XLA answer to bounce
divergence (SURVEY.md §7 hard part (e)).

The chunked engine (`ops/render.py`) pays ``samples x 50`` full-width bounce
steps per chunk even though most paths die in a handful of bounces (miss ->
sky, or absorbed): measured on scene 0, the early-exit never fires before
the bounce cap, so ~90% of lanes are masked waste.

This engine instead keeps a fixed-size *ray pool*.  Every iteration:

  1. lanes whose path finished are scattered (``.at[].add``) into the
     framebuffer accumulator,
  2. finished lanes are *refilled in place* with the next (pixel, sample)
     work items from a global counter (camera rays are regenerated from pure
     counter RNG — no state to carry),
  3. one `bounce_step` advances the whole pool (lanes at mixed samples /
     depths, each drawing from its own RNG counters).

The pool therefore stays dense as long as any work remains: total step
count ~= total path segments / pool size + one tail, an order of magnitude
fewer full-width steps than the chunked schedule.  This is the persistent-
threads/wavefront formulation of the literature (PAPERS.md) recast as an
XLA `while_loop`; the per-(pixel, sample, bounce) RNG keying makes every
radiance sample bit-identical to the chunked engines — only the f32
framebuffer accumulation order differs (tested in tests/test_wavefront.py).

Inference-only: the scatter/refill control flow is not reverse-mode
differentiable; gradient work uses the scan-based `trace` path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig
from . import hit as hit_ops
from .integrator import bounce_step
from .raygen import generate_rays


@functools.partial(
    jax.jit,
    static_argnames=("meta", "width", "height", "spp", "seed", "max_bounces",
                     "t_min", "pool", "engine", "npix_local"),
)
def render_wavefront_frame(
    scene: SceneArrays,
    bvh,
    *,
    meta: SceneMeta,
    width: int,
    height: int,
    spp: int,
    seed: int,
    max_bounces: int,
    t_min: float,
    pool: int,
    samp_base=0,
    engine: str = "bruteforce",
    npix_local: int | None = None,
    pix_base=0,
):
    """Radiance SUM over samples [samp_base, samp_base+spp) -> [npix, 3]
    (bottom-up raster order; caller divides by total spp and applies gamma).

    Sharded use (`parallel/render.py`): ``npix_local``/``pix_base`` restrict
    the frame to a contiguous pixel window — work items index local pixels,
    RNG counters and camera rays use the global id ``pix_base + local``.
    ``samp_base``/``pix_base`` are traced (mesh-position dependent)."""
    dtype = scene.camera.origin.dtype
    npix = npix_local if npix_local is not None else width * height
    n_work = npix * spp
    P = min(pool, n_work)
    P = -(-P // 512) * 512

    if engine == "bvh":
        from .bvh_engine import bvh_closest_hit, pack_tables

        tabs = pack_tables(scene, bvh)

        def hit_fn(o, d, time, tm, u_med):
            return bvh_closest_hit(scene, meta, tabs, o, d, time, tm, u_med)
    else:
        der = hit_ops.derive(scene)

        def hit_fn(o, d, time, tm, u_med):
            return hit_ops.closest_hit(scene, meta, der, o, d, time, tm, u_med)

    def refill(done, next_ray, state):
        """Assign the next work items to finished lanes, in lane order."""
        o, d, time, thr, acc, pix_ctr, pix_id, samp, bounce, active = state
        rank = jnp.cumsum(done.astype(jnp.int32)) - done.astype(jnp.int32)
        new_k = next_ray + rank
        take = done & (new_k < n_work)
        # work item k -> (pixel = k % npix, sample = k // npix): early waves
        # sweep the full frame first, like the chunked engine's sample loop
        new_pix = (new_k % npix).astype(jnp.int32)       # local (fb index)
        new_samp = (new_k // npix + jnp.int32(samp_base)).astype(jnp.uint32)
        no, nd, ntime, npc = generate_rays(
            scene.camera, new_pix + jnp.int32(pix_base), new_samp,
            width, height, seed
        )
        sel = lambda n, old: jnp.where(take[:, None] if old.ndim == 2 else take, n, old)
        o = sel(no, o)
        d = sel(nd, d)
        time = sel(ntime, time)
        thr = sel(jnp.ones_like(thr), thr)
        acc = sel(jnp.zeros_like(acc), acc)
        pix_ctr = sel(npc, pix_ctr)
        pix_id = sel(new_pix, pix_id)
        samp = sel(new_samp, samp)
        bounce = sel(jnp.zeros_like(bounce), bounce)
        active = jnp.where(done, take, active)
        next_ray = jnp.minimum(
            next_ray + done.sum(dtype=jnp.int32), jnp.int32(n_work)
        ).astype(jnp.int32)
        return next_ray, (o, d, time, thr, acc, pix_ctr, pix_id, samp, bounce, active)

    # finished paths are scattered into the framebuffer every iteration
    def cond(carry):
        fb, next_ray, done, state = carry
        active = state[-1]
        return (next_ray < n_work) | active.any()

    def body(carry):
        fb, next_ray, done, state = carry
        active = state[-1]
        # 1. scatter finished paths into the framebuffer
        emit = active & done
        acc = state[4]
        pix_id = state[6]
        fb = fb.at[pix_id].add(jnp.where(emit[:, None], acc, 0.0),
                               mode="drop")
        # 2. refill finished lanes with fresh work
        next_ray, state = refill(done, next_ray, state)
        o, d, time, thr, acc, pix_ctr, pix_id, samp, bounce, active = state
        # 3. advance every live lane one bounce
        o, d, thr, acc, alive2 = bounce_step(
            scene, meta, hit_fn, o, d, time, thr, acc, active,
            pix_ctr, samp, bounce, t_min=t_min,
        )
        bounce = bounce + 1
        done = ~alive2 | (bounce >= max_bounces)
        state = (o, d, time, thr, acc, pix_ctr, pix_id, samp, bounce, active)
        return fb, next_ray, done, state

    z3 = jnp.zeros((P, 3), dtype)
    z1 = jnp.zeros(P, dtype)
    state0 = (
        z3, z3, z1, z3, z3,
        jnp.zeros(P, jnp.uint32),            # pix_ctr
        jnp.zeros(P, jnp.int32),             # pix_id
        jnp.zeros(P, jnp.uint32),            # samp
        jnp.zeros(P, jnp.int32),             # bounce
        jnp.zeros(P, bool),                  # active
    )
    fb0 = jnp.zeros((npix, 3), dtype)
    carry = (fb0, jnp.int32(0), jnp.ones(P, bool), state0)
    fb, _, _, _ = lax.while_loop(cond, body, carry)
    return fb


@functools.partial(jax.jit, static_argnames=("gamma", "out_u8"))
def _finalize(fb, spp, gamma, out_u8):
    """Average + gamma (+ reference clamp/quantize) on device."""
    fb = fb / jnp.asarray(spp, fb.dtype)
    if gamma:
        fb = jnp.sqrt(jnp.maximum(fb, 0.0))  # gamma 2.0, kernel.cu:150-152
    if out_u8:
        fb = (256.0 * jnp.clip(fb, 0.0, 0.999)).astype(jnp.uint8)
    return fb


_ACCEL_CACHE: dict = {}


def _accel_for(scene: SceneArrays, engine: str):
    """Host-side acceleration tables, cached per (scene identity, engine) —
    profiling showed the packers re-running per render call (~0.3 s).
    Keyed on every scene leaf with identity verification
    (`scene.compiler.cached_pack`; ADVICE round 1 + training staleness)."""
    from ..scene.compiler import cached_pack

    def build():
        if engine == "wavefront_bvh":
            from ..scene.bvh import build_scene_bvh

            return build_scene_bvh(scene)
        return None

    return cached_pack(_ACCEL_CACHE, scene, engine, build)


def render_wavefront(
    scene: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    *,
    gamma: bool = True,
    out_u8: bool = False,
) -> np.ndarray:
    """Full-frame wavefront render -> numpy [H,W,3] (top row first).

    ``out_u8``: gamma + the reference's clamp/quantize (kernel.cu:709-718)
    run on-device and a uint8 frame is transferred.
    """
    bvh = _accel_for(scene, cfg.engine)
    fb = render_wavefront_frame(
        scene, bvh,
        meta=meta, width=cfg.width, height=cfg.height,
        spp=cfg.samples_per_pixel, seed=cfg.seed,
        max_bounces=cfg.max_bounces, t_min=cfg.t_min,
        pool=cfg.rays_per_batch,
        engine="bvh" if cfg.engine == "wavefront_bvh" else "bruteforce",
    )
    fb = _finalize(fb, cfg.samples_per_pixel, gamma, out_u8)
    fb = np.asarray(fb).reshape(cfg.height, cfg.width, -1)
    return fb[::-1]
