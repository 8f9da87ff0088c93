"""Threaded-BVH closest-hit engine.

Data-parallel redesign of the reference's BVH traversal (`BvhNode.h:101-158`).
The reference walks the tree with a per-thread explicit 32-entry stack; on a
vector machine a per-lane stack means a [B,32] scatter/gather per step.  The
threaded layout (`scene/bvh.py`) eliminates the stack: each ray's traversal
state is ONE integer — descend to ``node+1`` on an AABB hit of an internal
node, else jump to ``escape[node]``.  The whole batch advances in lockstep
(`lax.while_loop` until every lane has walked off the end), and every per-
step node/primitive access is a single packed-row gather.

Leaf tests reproduce the sphere/quad hit math of `ops/hit.py` for one
gathered primitive per (ray, step); closest-so-far prunes AABBs exactly like
the reference's shrinking tMax (`BvhNode.h:150`).  Constant media are tested
brute-force alongside (M <= 3 in every reference scene) and merged before
record assembly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core import vecmath as vm
from ..scene.bvh import BvhArrays
from ..scene.compiler import SceneArrays
from . import hit as hit_ops
from .integrator import trace

BIG = hit_ops.BIG


def pack_tables(scene: SceneArrays, bvh: BvhArrays):
    """Pack node / primitive columns into single gather-friendly matrices
    (plus the shared `Derived` record/shade tables)."""
    f = jnp.asarray(scene.sph_rad).dtype
    as_f = lambda a: jnp.asarray(a, f)
    bits = lambda a: jax.lax.bitcast_convert_type(
        jnp.asarray(a, jnp.int32), jnp.float32
    ).astype(f) if f == jnp.float32 else jnp.asarray(a, f)
    # nodes: [M, 8] = lo(3) hi(3) prim esc   (prim/esc bitcast when f32)
    node_tab = jnp.concatenate(
        [as_f(bvh.nmin), as_f(bvh.nmax),
         bits(bvh.prim)[:, None], bits(bvh.escape)[:, None]], axis=1
    )
    # spheres: [S, 9] = c0(3) dc(3) t0 inv_dt rad
    sph_tab = jnp.concatenate(
        [as_f(scene.sph_c0), as_f(scene.sph_dc),
         as_f(scene.sph_t0)[:, None], as_f(scene.sph_inv_dt)[:, None],
         as_f(scene.sph_rad)[:, None]], axis=1
    )
    # quads: [Q, 12] = n_unit(3) d_plane vxw(3) q_vxw wxu(3) q_wxu
    der = hit_ops.derive(scene)
    dq = der.dq
    quad_tab = jnp.concatenate(
        [dq["n_unit"], dq["d_plane"][:, None],
         dq["vxw"], dq["q_vxw"][:, None],
         dq["wxu"], dq["q_wxu"][:, None]], axis=1
    )
    return node_tab, sph_tab, quad_tab, der


def bvh_closest_hit(
    scene: SceneArrays, meta, bvh_tabs, o, d, time, t_min, u_med
):
    """Stackless traversal -> HitRecord; same record semantics as
    hit.closest_hit (cross-checked bit-identical in tests/test_bvh.py)."""
    node_tab, sph_tab, quad_tab, der = bvh_tabs
    dt = o.dtype
    B = o.shape[0]
    M = node_tab.shape[0]
    S = scene.sph_c0.shape[0]
    is_f32 = dt == jnp.float32

    def unbits(x):
        if is_f32:
            return jax.lax.bitcast_convert_type(x, jnp.int32)
        return x.astype(jnp.int32)

    inv_d = 1.0 / d                                  # per-ray, hoisted
    a_coef = vm.dot(d, d)
    o_d = vm.dot(o, d)

    def cond(state):
        node, _, _ = state
        return (node < M).any()

    def body(state):
        node, t_best, best_p = state
        live = node < M
        nid = jnp.minimum(node, M - 1)
        rows = jnp.take(node_tab, nid, axis=0)       # [B,8] one gather
        lo, hi = rows[:, 0:3], rows[:, 3:6]
        prim = unbits(rows[:, 6])
        esc = unbits(rows[:, 7])

        # branchless slab test w/ shrinking tMax (AABB.h:68-98, BvhNode.h:150)
        # fminf/fmaxf semantics: when a ray direction component is exactly 0
        # and the origin sits on a slab bound, 0*inf = NaN appears in ta/tb;
        # CUDA's fminf/fmaxf suppress NaN (return the other operand) while
        # jnp.minimum propagates it, which would cull a node the brute-force
        # engine hits.  NaN can only appear in ta or tb (not both unless the
        # slab is degenerate), so select the non-NaN operand explicitly.
        ta = (lo - o) * inv_d
        tb = (hi - o) * inv_d
        slab_min = jnp.where(ta < tb, ta, jnp.where(jnp.isnan(tb), ta, tb))
        slab_max = jnp.where(ta > tb, ta, jnp.where(jnp.isnan(tb), ta, tb))
        near = jnp.maximum(slab_min.max(-1), t_min)
        far = jnp.minimum(slab_max.min(-1), t_best)
        box_hit = (far > near) & live

        is_leaf = prim >= 0
        test = box_hit & is_leaf

        # ---- leaf sphere test (Sphere.h:29-59 / MovingSphere.h:52-58)
        sid = jnp.clip(prim, 0, S - 1)
        srow = jnp.take(sph_tab, sid, axis=0)        # [B,9]
        frac = (time - srow[:, 6]) * srow[:, 7]
        center = srow[:, 0:3] + frac[:, None] * srow[:, 3:6]
        oc = o - center
        b_half = (oc * d).sum(-1)
        c_coef = (oc * oc).sum(-1) - srow[:, 8] * srow[:, 8]
        disc = b_half * b_half - a_coef * c_coef
        dpos = disc > 0.0
        sq = jnp.sqrt(jnp.where(dpos, disc, 1.0))  # NaN-safe backward
        root1 = (-b_half - sq) / a_coef
        root2 = (-b_half + sq) / a_coef
        t_sph = jnp.where(root1 > t_min, root1, root2)
        sph_ok = dpos & (t_sph > t_min)

        # ---- leaf quad test (Quad.h:52-99)
        qid = jnp.clip(prim - S, 0, quad_tab.shape[0] - 1)
        qrow = jnp.take(quad_tab, qid, axis=0)       # [B,12]
        n_unit = qrow[:, 0:3]
        denom = (d * n_unit).sum(-1)
        denom_ok = jnp.abs(denom) >= hit_ops.QUAD_PARALLEL_EPS
        t_quad = (qrow[:, 3] - (o * n_unit).sum(-1)) / jnp.where(denom_ok, denom, 1.0)
        pq = o + t_quad[:, None] * d
        alpha = (pq * qrow[:, 4:7]).sum(-1) - qrow[:, 7]
        beta = (pq * qrow[:, 8:11]).sum(-1) - qrow[:, 11]
        quad_ok = (
            denom_ok & (t_quad >= t_min)
            & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        )

        is_sph = prim < S
        t_cand = jnp.where(is_sph, t_sph, t_quad)
        ok = test & jnp.where(is_sph, sph_ok, quad_ok) & (t_cand < t_best)
        t_best = jnp.where(ok, t_cand, t_best)
        best_p = jnp.where(ok, prim, best_p)

        node = jnp.where(live, jnp.where(box_hit & ~is_leaf, node + 1, esc), node)
        return node, t_best, best_p

    node0 = jnp.zeros(B, jnp.int32) + (0 if M > 0 else M)
    state = (node0, jnp.full(B, dt.type(BIG)), jnp.full(B, -1, jnp.int32))
    _, t_best, best_p = lax.while_loop(cond, body, state)

    # merge stochastic media + assemble (shared tail, ops/hit.py)
    return hit_ops.record_from_geo_winner(
        scene, meta, der, o, d, time, t_min, u_med,
        jnp.where(best_p >= 0, t_best, dt.type(BIG)), best_p)


def trace_bvh(
    scene: SceneArrays, meta, bvh: BvhArrays, o, d, time, pix_ctr, sample, *,
    max_bounces: int, t_min: float, differentiable: bool = False,
):
    """BVH-accelerated `trace` (same bounce-loop semantics, ops/integrator.py)."""
    tabs = pack_tables(scene, bvh)

    def hit_fn(o, d, time, tm, u_med):
        return bvh_closest_hit(scene, meta, tabs, o, d, time, tm, u_med)

    return trace(
        scene, meta, o, d, time, pix_ctr, sample,
        max_bounces=max_bounces, t_min=t_min, differentiable=differentiable,
        hit_fn=hit_fn,
    )
