"""Multi-device rendering: shard_map over a device mesh.

The reference is a single-GPU program whose only parallelism is SIMT over
pixels (`kernel.cu:122-154, 575-576`: one thread per pixel, 8x8 blocks) with
a sequential per-thread sample loop (`kernel.cu:138-144`).  Across devices
those two axes become *mesh axes*:

  * ``px`` — pixel data parallelism: the flattened pixel index space is
    sharded across devices; the scene tables are replicated on every device
    (SURVEY.md §2 "Distributed communication backend").
  * ``sp`` — sample parallelism: samples-per-pixel are split across devices
    and the radiance estimates summed with a single ``psum`` — the
    workload's analogue of sequence parallelism (SURVEY.md §5).

The shard body is the *same* single-device engine; SPMD means one program
for one device or many.  Multi-host runs use the identical program after
``jax.distributed.initialize``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig
from ..ops.dispatch import trace_dispatch
from ..ops.raygen import generate_rays

AXIS_PX = "px"
AXIS_SP = "sp"


def _put_replicated(x, mesh: Mesh):
    """Replicate a host array onto every device of ``mesh``.

    Single-process: plain `device_put`.  Multi-process (after
    `jax.distributed.initialize`): `device_put` may reject shardings that
    span non-addressable devices, so fall back to
    `make_array_from_callback`, which assembles the global array from
    each process's local shards (every process passes identical host
    values, so the result is the same replicated array)."""
    s = NamedSharding(mesh, P())
    try:
        return jax.device_put(x, s)
    except ValueError:
        arr = np.asarray(x)
        return jax.make_array_from_callback(arr.shape, s,
                                            lambda idx: arr[idx])


def make_mesh(
    devices=None, sample_shards: int | None = None
) -> Mesh:
    """Build a ``(px, sp)`` mesh over ``devices`` (default: all local).

    ``sample_shards`` defaults to 2 when the device count is even and > 1
    (samples are the cheaper axis to split: one psum, no pixel scatter).
    """
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    if sample_shards is None:
        sample_shards = 2 if (n % 2 == 0 and n > 1) else 1
    if n % sample_shards != 0:
        raise ValueError(f"{n} devices not divisible by sample_shards={sample_shards}")
    arr = np.asarray(devices).reshape(n // sample_shards, sample_shards)
    return Mesh(arr, (AXIS_PX, AXIS_SP))


def _sharded_chunk_fn(meta: SceneMeta, cfg: RenderConfig, mesh: Mesh, gamma: bool,
                      bvh=None):
    """Compile the per-chunk shard_map program: pix ids [P] -> colors [P,3].

    ``bvh`` (when engine == "bvh") is closed over as a jit constant — the
    node table is tiny and replicated on every device by construction.
    """
    n_sp = mesh.shape[AXIS_SP]
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} must be divisible by sample shards {n_sp}")
    local_spp = spp // n_sp
    W, H = cfg.width, cfg.height

    def body(scene: SceneArrays, pix: jnp.ndarray):
        dtype = scene.camera.origin.dtype
        sp_idx = lax.axis_index(AXIS_SP)

        def sample_body(s, acc):
            s_global = (sp_idx * local_spp + s).astype(jnp.uint32)
            o, d, time, pix_ctr = generate_rays(scene.camera, pix, s_global, W, H, cfg.seed)
            col = trace_dispatch(
                scene, meta, o, d, time, pix_ctr, s_global, engine=cfg.engine,
                bvh=bvh, max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                differentiable=cfg.differentiable,
            )
            return acc + col

        acc = lax.fori_loop(
            0, local_spp, sample_body, jnp.zeros((pix.shape[0], 3), dtype)
        )
        col = lax.psum(acc, AXIS_SP) / dtype.type(spp)   # sample average, kernel.cu:147
        if gamma:
            col = jnp.sqrt(jnp.maximum(col, 0.0))        # gamma 2.0, kernel.cu:150-152
        return col

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(AXIS_PX)),       # scene replicated; pixels sharded
        out_specs=P(AXIS_PX),
        check_vma=False,
    )
    return jax.jit(sharded)


def _sharded_wavefront(scene, meta, cfg: RenderConfig, mesh: Mesh, gamma: bool):
    """Wavefront engine per shard: each (px, sp) device runs the persistent
    pool over its contiguous pixel window and its sample slice; one psum
    merges the sample axis.  Same image as the one-device engine (counter
    RNG on global ids) up to f32 sample-sum association."""
    from ..ops.wavefront import render_wavefront_frame

    W, H = cfg.width, cfg.height
    npix = W * H
    n_px = mesh.shape[AXIS_PX]
    n_sp = mesh.shape[AXIS_SP]
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} not divisible by sample shards {n_sp}")
    spp_local = spp // n_sp
    npix_local = -(-npix // n_px)

    hit_engine = "bruteforce"
    accel = None
    if cfg.engine == "wavefront_bvh":
        from ..scene.bvh import build_scene_bvh

        accel = build_scene_bvh(scene)
        hit_engine = "bvh"

    def body(scene_arg):
        i = lax.axis_index(AXIS_PX)
        j = lax.axis_index(AXIS_SP)
        fb = render_wavefront_frame(
            scene_arg, accel,
            meta=meta, width=W, height=H, spp=spp_local, seed=cfg.seed,
            max_bounces=cfg.max_bounces, t_min=cfg.t_min,
            pool=cfg.rays_per_batch, engine=hit_engine,
            npix_local=npix_local, pix_base=i * npix_local,
            samp_base=j * spp_local,
        )
        return lax.psum(fb, AXIS_SP)     # merge sample-shard partial sums

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(),),                 # scene replicated
        out_specs=P(AXIS_PX),            # contiguous pixel windows
        check_vma=False,
    )
    fb = jax.jit(sharded)(jax.device_put(
        scene, jax.tree.map(lambda _: NamedSharding(mesh, P()), scene)))
    fb = np.asarray(fb, np.float64)[:npix] / spp
    if gamma:
        fb = np.sqrt(np.maximum(fb, 0.0))
    return fb.reshape(H, W, 3)[::-1]


def _mega2_shard_setup(scene, meta, cfg: RenderConfig, mesh: Mesh):
    """Tables, kernel spec and per-shard lane count of the sharded
    megakernel render."""
    from ..ops.mega2 import LANES, kernel_spec, mega2_tables

    n_px = mesh.shape[AXIS_PX]
    n_sp = mesh.shape[AXIS_SP]
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} not divisible by sample shards {n_sp}")
    tabs, layout, med, _remap = mega2_tables(scene, meta)
    spec = kernel_spec(scene, meta, layout, med, seed=cfg.seed,
                       max_bounces=cfg.max_bounces, t_min=cfg.t_min)
    npix = cfg.width * cfg.height
    span = -(-(-(-npix // n_px)) // LANES) * LANES
    return tabs, spec, span, spp // n_sp


def _shard_lanes(span: int, n_px: int, npix: int):
    """Pixel ids of this px shard: STRIDED (shard i traces pixels i,
    i+n_px, ...), so every shard samples the whole image interleaved and
    per-shard work balances to Monte-Carlo noise (contiguous windows are
    content-imbalanced)."""
    ids = lax.axis_index(AXIS_PX) + n_px * lax.iota(jnp.int32, span)
    return jnp.where(ids < npix, ids, -1)


def _sharded_mega2(scene, meta, cfg: RenderConfig, mesh: Mesh, gamma: bool):
    """Megakernel per shard: each (px, sp) device runs the kernel over its
    strided pixel lanes for its sample slice, then one psum merges the
    sample axis.  RNG keys on global (pixel, sample) ids — the sample base
    enters the kernel as ``samp0`` — so the mesh layout is invisible in the
    image up to f32 sample-sum association (bit-identical when the sample
    axis is unsharded)."""
    from ..ops.backend import pallas_interpret
    from ..ops.mega2 import render_lanes
    from ..ops.wavefront import _finalize

    tabs, spec, span, spp_local = _mega2_shard_setup(scene, meta, cfg, mesh)
    n_px = mesh.shape[AXIS_PX]
    npix = cfg.width * cfg.height
    interpret = pallas_interpret()

    def body(tabs):
        pix = _shard_lanes(span, n_px, npix)
        sums, _ = render_lanes(spec, tabs, pix, spp=spp_local,
                               width=cfg.width, height=cfg.height,
                               samp0=lax.axis_index(AXIS_SP) * spp_local,
                               interpret=interpret)
        fb = lax.psum(sums.T, AXIS_SP)   # merge sample-shard partial sums
        # the px axis's ONE collective: a replicated output is addressable
        # by every process of a multi-host run
        return lax.all_gather(fb, AXIS_PX)      # [n_px, span, 3]

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(P(),),
                            out_specs=P(), check_vma=False)

    @jax.jit
    def frame(tabs, spp):
        # de-interleave: stacked[i, k] holds pixel i + n_px*k; the epilogue
        # is the one-device frame's own (spp a runtime value there too), so
        # a px-only mesh is bit-identical
        fb = sharded(tabs).swapaxes(0, 1).reshape(-1, 3)[:npix]
        return _finalize(fb, spp, gamma, False)

    tabs_dev = jax.tree.map(lambda t: _put_replicated(jnp.asarray(t), mesh),
                            tabs)
    fb = np.asarray(frame(tabs_dev, jnp.int32(cfg.samples_per_pixel)))
    return fb.reshape(cfg.height, cfg.width, 3)[::-1]


def shard_work_stats(scene, meta, cfg: RenderConfig, mesh: Mesh | None = None):
    """Path segments traced by each px shard of the sharded megakernel
    render — the load-balance measurement behind px-axis scaling.
    Returns segs[n_px] (numpy int64)."""
    from ..ops.backend import pallas_interpret
    from ..ops.mega2 import render_lanes

    if mesh is None:
        mesh = make_mesh()
    tabs, spec, span, spp_local = _mega2_shard_setup(scene, meta, cfg, mesh)
    n_px = mesh.shape[AXIS_PX]
    npix = cfg.width * cfg.height
    interpret = pallas_interpret()

    def body(tabs):
        pix = _shard_lanes(span, n_px, npix)
        _, segs = render_lanes(spec, tabs, pix, spp=spp_local,
                               width=cfg.width, height=cfg.height,
                               samp0=lax.axis_index(AXIS_SP) * spp_local,
                               interpret=interpret)
        return lax.psum(jnp.sum(segs), AXIS_SP).reshape(1)

    sharded = jax.shard_map(body, mesh=mesh, in_specs=(P(),),
                            out_specs=P(AXIS_PX), check_vma=False)
    return np.asarray(jax.jit(sharded)(tabs), np.int64)


def render_sharded(
    scene: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    mesh: Mesh | None = None,
    *,
    gamma: bool = True,
) -> np.ndarray:
    """Render a full frame on a device mesh -> numpy [H,W,3] (top row first).

    Semantically identical (bit-identical per pixel on a given backend) to the
    one-device `ops.render.render`: the counter RNG keys on global pixel and
    sample ids, so the sharding layout is invisible in the output.
    """
    if mesh is None:
        mesh = make_mesh()
    if cfg.engine == "mega2":
        return _sharded_mega2(scene, meta, cfg, mesh, gamma)
    if cfg.engine.startswith("wavefront"):
        return _sharded_wavefront(scene, meta, cfg, mesh, gamma)
    W, H = cfg.width, cfg.height
    npix = W * H
    n_px = mesh.shape[AXIS_PX]

    # chunk size: multiple of n_px, close to cfg.rays_per_batch per device
    per_dev = min(cfg.rays_per_batch, -(-npix // n_px))
    chunk = per_dev * n_px
    bvh = None
    if cfg.engine == "bvh":
        from ..scene.bvh import build_scene_bvh

        bvh = build_scene_bvh(scene)
    fn = _sharded_chunk_fn(meta, cfg, mesh, gamma, bvh)

    scene_sharding = jax.tree.map(
        lambda _: NamedSharding(mesh, P()), scene
    )
    scene_dev = jax.device_put(scene, scene_sharding)
    pix_sharding = NamedSharding(mesh, P(AXIS_PX))

    out = np.zeros((npix, 3), np.float64)
    for start in range(0, npix, chunk):
        ids = np.arange(start, start + chunk, dtype=np.int32)
        valid = ids < npix
        ids_c = np.minimum(ids, npix - 1)
        col = fn(scene_dev, jax.device_put(jnp.asarray(ids_c), pix_sharding))
        out[ids_c[valid]] = np.asarray(col, np.float64)[valid]
    fb = out.reshape(H, W, 3)   # row 0 = bottom scanline (kernel.cu:131)
    return fb[::-1]
