"""Differentiable rendering: sharded gradient/train step over the mesh.

This is the framework's extension beyond the reference (BASELINE.json
north-star): pixel gradients w.r.t. scene parameters (sphere centers/radii,
material albedo/fuzz/IOR, quad frames, camera) flow through the bounce loop
(`ops/integrator.trace` in its scan+checkpoint form), and a full train step
runs SPMD on the ``(px, sp)`` mesh:

  * every chip differentiates its own pixel/sample shard's contribution,
  * the per-sample radiance is psum-averaged over ``sp`` *inside* the loss
    (MSE needs the mean before squaring),
  * parameter gradients are psum-reduced over both mesh axes (the gradient
    all-reduce; this is the collective the reference never needed because
    it had no learnable state).

Visibility discontinuities are ignored as in standard differentiable
path-tracing practice (SURVEY.md §7.4); gradients are validated against
finite differences on smooth parameters in tests/test_grad.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.integrator import trace
from ..ops.raygen import generate_rays
from ..ops.replay import replay, trace_taped
from ..scene.compiler import SceneArrays, SceneMeta
from ..utils.config import RenderConfig
from .render import AXIS_PX, AXIS_SP

# Float leaves a user can optimize.  Integer/bool columns (kind tags, material
# ids, active masks) and RNG tables are structural, not parameters.
DIFF_SCENE_FIELDS = (
    "sph_c0", "sph_dc", "sph_rad",        # sphere geometry
    "quad_q", "quad_u", "quad_v",         # quad frames
    "mat_fuzz", "mat_ior",                # material scalars
    "tex_c0", "tex_c1",                   # albedo / emission colors
)


def split_params(scene: SceneArrays):
    """scene -> params pytree (the differentiable leaves, camera included —
    every CameraParams leaf is a float array).

    The scene itself is returned unmodified by the caller's hands: pass any
    scene with matching structure (typically the original) as the residual to
    ``merge_params(residual, params)``, which overlays the params onto it.
    """
    params = {f: getattr(scene, f) for f in DIFF_SCENE_FIELDS}
    params["camera"] = scene.camera
    return params


def merge_params(scene: SceneArrays, params) -> SceneArrays:
    kw = {f: params[f] for f in DIFF_SCENE_FIELDS}
    return scene._replace(camera=params["camera"], **kw)


class TrainState(NamedTuple):
    params: dict
    opt_state: tuple
    step: jnp.ndarray


def make_train_step(
    scene: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
    engine: str = "auto",
):
    """Build the jitted SPMD train step.

    Returns ``step(state, pix, target) -> (state, loss)`` where ``pix`` is a
    [B] pixel-id batch (B divisible by the px mesh dim) and ``target`` the
    matching [B,3] linear-radiance target.  Loss is MSE in linear radiance
    (the gamma sqrt is non-differentiable at 0 and excluded from the loss
    path; it remains a display epilogue).

    ``engine`` selects the differentiable trace:
      * ``"taped"`` — `ops/replay.trace_taped`: winner-taped, O(1) work
        and memory per segment in the primitive count.  After collapsing
        the replay's per-column winner gathers into the packed-table
        gathers `assemble_record` already issues (one gather — and one
        scatter-add transpose — per bounce), it is the only path whose
        cost does not grow with the scene.
      * ``"scan"`` — `ops/integrator.trace(differentiable=True)`:
        scan + checkpoint through the full closest-hit search.  O(S) per
        bounce; kept as the gradient oracle for parity tests.
      * ``"auto"`` (default) — taped.
    """
    if engine == "auto":
        engine = "taped"
    if engine == "taped":
        trace_diff = trace_taped
    elif engine == "scan":
        trace_diff = functools.partial(trace, differentiable=True)
    else:
        raise ValueError(f"unknown differentiable engine: {engine!r}")
    n_sp = mesh.shape[AXIS_SP]
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} must be divisible by sample shards {n_sp}")
    local_spp = spp // n_sp
    W, H = cfg.width, cfg.height
    dcfg = cfg.with_(differentiable=True)

    def shard_body(params, scene_rest, pix, target):
        sp_idx = lax.axis_index(AXIS_SP)

        def local_acc(p):
            """This shard's sample-slice radiance partial sum [B, 3] —
            collective-free, so its vjp is exactly the shard-local
            cotangent path with no psum-transpose semantics involved."""
            sc = merge_params(scene_rest, p)

            def sample_body(s, acc):
                s_global = (sp_idx * local_spp + s).astype(jnp.uint32)
                o, d, time, pix_ctr = generate_rays(
                    sc.camera, pix, s_global, W, H, cfg.seed
                )
                col = trace_diff(
                    sc, meta, o, d, time, pix_ctr, s_global,
                    max_bounces=dcfg.max_bounces, t_min=dcfg.t_min,
                )
                return acc + col

            return lax.fori_loop(
                0, local_spp, sample_body,
                jnp.zeros((pix.shape[0], 3), sc.camera.origin.dtype),
            )

        acc, vjp_fn = jax.vjp(local_acc, params)
        dt = acc.dtype.type
        col = lax.psum(acc, AXIS_SP) / dt(spp)
        diff = col - target
        denom = 3.0 * pix.shape[0] * mesh.shape[AXIS_PX]
        loss = lax.psum((diff * diff).sum(), AXIS_PX) / denom  # repl. over sp
        # The MSE chain rule is applied OUTSIDE autodiff: dloss/d(acc_s) =
        # 2*diff/(spp*denom) identically on every sp shard (col is
        # replicated), so vjp-ing only the collective-free local_acc and
        # psum-ing the per-shard cotangent results counts every sample
        # path exactly once.  Differentiating through the psum instead
        # double-counts under check_vma=False (psum's transpose there is
        # psum, n_sp-scaling every gradient — caught by the marble mesh
        # test against the unsharded reference).
        cot = diff * dt(2.0 / (spp * denom))
        (grads,) = vjp_fn(cot)
        grads = jax.tree.map(
            lambda g: lax.psum(g, (AXIS_PX, AXIS_SP)), grads
        )
        return loss, grads

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS_PX), P(AXIS_PX)),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step_jit(state: TrainState, scene_rest: SceneArrays, pix, target):
        loss, grads = sharded(state.params, scene_rest, pix, target)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    def step(state: TrainState, scene_rest: SceneArrays, pix, target):
        # commit the state to the mesh-replicated sharding the jit's
        # outputs carry: an eagerly-built init state is UNcommitted, and
        # the sharding mismatch between step 0's inputs and step 1's
        # (step 0's outputs) forces a full second compile otherwise
        state = _commit_replicated(state, mesh)
        return step_jit(state, scene_rest, pix, target)

    return step


def _commit_replicated(state: TrainState, mesh: Mesh) -> TrainState:
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), state)


def init_state(scene: SceneArrays, optimizer: optax.GradientTransformation) -> TrainState:
    params = split_params(scene)
    params = jax.tree.map(jnp.asarray, params)
    return TrainState(params, optimizer.init(params), jnp.int32(0))


def make_train_step_mega2(
    scene: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh | None = None,
):
    """Fast train step: megakernel winner tapes + the XLA replay gradient.

    With ``mesh=None`` — the one-device two-phase step (the tape's
    geometry/material tables are packed host-side from CONCRETE params, so
    tape generation cannot live inside the gradient jit):

      1. the megakernel's trace mode runs ALL spp samples in ONE device
         dispatch and returns the winner tapes [spp, max_bounces, B]
         (global scene ids), from the rays of the current camera;
      2. jitted — MSE loss through `ops.replay.replay` (one gather of the
         winner's merged row per bounce; XLA emits its backward as a
         scatter-add), then the optimizer update.

    With a ``(px, sp)`` ``mesh`` — the SPMD composition of the same pieces
    (`_make_train_step_mega2_sharded`): per shard, the trace kernel AND the
    replay run inside one shard_map'd jit, the per-sample radiance
    psum-merges over ``sp`` inside the loss, and the parameter gradients
    psum over BOTH axes.  Tables are still packed eagerly per step from
    the concrete params.

    The tape is a valid pathwise sample wherever it came from, so the
    gradient matches `trace_taped` a.e. (winner ties excepted).  Pixel
    batches may be scattered (lanes are gathered in-graph);
    `make_train_step` remains the general XLA path.
    """
    from ..ops.backend import pallas_interpret
    from ..ops.mega2 import _tapes_jit

    # device arrays: the replay indexes table leaves with traced ids
    scene = jax.tree.map(jnp.asarray, scene)
    if mesh is not None:
        return _make_train_step_mega2_sharded(
            scene, meta, cfg, optimizer, mesh)
    spp = cfg.samples_per_pixel
    W, H = cfg.width, cfg.height

    @jax.jit
    def grad_step(state: TrainState, tapes, pix, target):
        def loss_fn(p):
            sc = merge_params(scene, p)
            img = jnp.zeros((pix.shape[0], 3), sc.camera.origin.dtype)
            for s in range(spp):
                o, d, time, pix_ctr = generate_rays(
                    sc.camera, pix, jnp.uint32(s), W, H, cfg.seed)
                img = img + replay(
                    sc, meta, tapes[s], o, d, time, pix_ctr,
                    jnp.uint32(s), max_bounces=cfg.max_bounces,
                    t_min=cfg.t_min)
            diff = img / spp - target
            return (diff * diff).sum() / (3.0 * pix.shape[0])

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    def step(state: TrainState, pix, target):
        sc = merge_params(scene, state.params)
        tabs, spec, remap = _tape_kernel_inputs(sc, meta, cfg)
        tapes = _tapes_jit(tabs, remap, jnp.asarray(pix, jnp.int32),
                           sc.camera, spec=spec, width=W, height=H,
                           n_samples=spp, interpret=pallas_interpret())
        return grad_step(state, tapes, jnp.asarray(pix, jnp.int32), target)

    return step


def _tape_kernel_inputs(sc: SceneArrays, meta: SceneMeta,
                        cfg: RenderConfig):
    """(tables, kernel spec, remap) for the trace kernel of the fast step.

    The camera stays out of the spec (tapes start from in-graph rays of
    the possibly traced camera, the replay's very rays), and so does the
    medium albedo (cols 19:22): it is trainable but cannot affect winners.
    So training moves no compile-time constant; the kernel recompiles only
    when the table layout changes."""
    from ..ops.mega2 import kernel_spec, mega2_tables

    tabs, layout, med, remap = mega2_tables(sc, meta)
    med_t = np.asarray(med, np.float64).copy()
    med_t[:, 19:22] = 0.0
    spec = kernel_spec(sc, meta, layout, med_t, seed=cfg.seed,
                       max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                       camera=False)
    return tabs, spec, remap


def _make_train_step_mega2_sharded(
    scene: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
):
    """SPMD composition of the fast gradient path over a (px, sp) mesh —
    built by `make_train_step_mega2(mesh=...)`.

    Per step: ONE eager host phase packs the megakernel tables from the
    concrete params (`ops.mega2.mega2_tables`), then ONE jitted dispatch
    runs, per shard, (a) the trace kernel over the shard's pixel slice and
    sample window (winner tapes — integers, outside autodiff), and (b) the
    XLA replay forward+backward through the MSE loss.  The per-sample
    radiance psums over ``sp`` inside the loss (MSE needs the mean before
    squaring) and the parameter gradients psum over both mesh axes.  RNG
    keys on global (pixel, sample) ids, so the mesh layout is invisible in
    the estimator.

    Primary rays for BOTH tape and replay come from the in-graph
    `generate_rays` on the traced camera (`_tapes_trace(camera=...)`),
    which keeps the trainable camera out of the trace kernel's
    compile-time constants (no recompile when camera params move) and
    makes tape and replay share the very same rays.  The tables are kernel
    inputs, so moving geometry recompiles only when the table layout
    changes.
    """
    from ..ops.backend import pallas_interpret
    from ..ops.mega2 import _tapes_trace

    n_px = mesh.shape[AXIS_PX]
    n_sp = mesh.shape[AXIS_SP]
    spp = cfg.samples_per_pixel
    if spp % n_sp != 0:
        raise ValueError(f"spp={spp} must be divisible by sample shards {n_sp}")
    spp_local = spp // n_sp
    W, H = cfg.width, cfg.height
    K = cfg.max_bounces
    interpret = pallas_interpret()
    _cache: dict = {}

    def build(spec):
        def body(params, tabs, remap, pix, target):
            samp0 = lax.axis_index(AXIS_SP) * spp_local
            cam0 = merge_params(scene, params).camera
            # (a) winner tapes for this shard's (pixel, sample) window —
            # integer output, invisible to autodiff by construction
            tapes = _tapes_trace(spec, tabs, remap, pix, width=W, height=H,
                                 n_samples=spp_local, samp0=samp0,
                                 interpret=interpret, camera=cam0)

            # (b) the XLA replay: this shard's radiance partial sum,
            # collective-free so its vjp is the shard-local cotangent path
            def local_acc(p):
                sc = merge_params(scene, p)
                img = jnp.zeros((pix.shape[0], 3), jnp.float32)
                for s in range(spp_local):
                    sg = (samp0 + s).astype(jnp.uint32)
                    o, d, time, pc = generate_rays(sc.camera, pix, sg, W, H,
                                                   cfg.seed)
                    img = img + replay(sc, meta, tapes[s], o, d, time, pc,
                                       sg, max_bounces=K, t_min=cfg.t_min)
                return img

            acc, vjp_fn = jax.vjp(local_acc, params)
            col = lax.psum(acc, AXIS_SP) / np.float32(spp)
            diff = col - target
            denom = 3.0 * pix.shape[0] * n_px
            loss = lax.psum((diff * diff).sum(), AXIS_PX) / denom
            # the MSE chain rule outside autodiff, as in make_train_step:
            # differentiating through the psum would n_sp-scale every
            # gradient under check_vma=False
            (grads,) = vjp_fn(diff * np.float32(2.0 / (spp * denom)))
            grads = jax.tree.map(
                lambda g: lax.psum(g, (AXIS_PX, AXIS_SP)), grads)
            return loss, grads

        sharded = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(), P(AXIS_PX), P(AXIS_PX)),
            out_specs=(P(), P()),
            check_vma=False)

        @jax.jit
        def grad_step(state: TrainState, tabs, remap, pix, target):
            loss, grads = sharded(state.params, tabs, remap, pix, target)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = optax.apply_updates(state.params, updates)
            return TrainState(params, opt_state, state.step + 1), loss

        return grad_step

    def step(state: TrainState, pix, target):
        state = _commit_replicated(state, mesh)   # see make_train_step
        sc = merge_params(scene, state.params)
        tabs, spec, remap = _tape_kernel_inputs(sc, meta, cfg)
        if spec not in _cache:
            _cache[spec] = build(spec)
        return _cache[spec](state, tabs, remap,
                            jnp.asarray(pix, jnp.int32), target)

    step.cache = _cache   # exposed so tests can pin the recompile count
    return step
