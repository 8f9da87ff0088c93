"""Taped-replay differentiable path: decouple the discrete path decisions
from the differentiable radiance computation.

The scan+checkpoint path (`integrator.trace(differentiable=True)`) drags the
full closest-hit SEARCH — [B, S] candidate tensors per bounce, plus their
reverse-mode residuals — through the autodiff graph, although the search
only *selects* which primitive each segment hits.  Pathwise gradients hold
the discrete path fixed (SURVEY.md §7.4: visibility discontinuities are
ignored, as in standard differentiable-PT practice), so the winner argmin is
locally constant a.e. and contributes nothing to the gradient.

This module splits the work accordingly:

  * `generate_tape` runs the bounce loop once, non-differentiably, and
    records each bounce's winner as a GLOBAL prim id [max_bounces, B] i32
    (sphere rows, then quads, then media; -1 = miss).  Any engine that can
    name its winner can produce this tape — the XLA closest-hit here, or
    the megakernel's trace mode (`ops/mega2.py`).  The tape is
    integer-valued, so autodiff never looks inside its producer.
  * `replay` recomputes the radiance with the winners FIXED: per bounce one
    [B]-row gather of the winner primitive, an analytic re-intersection
    (O(1) per segment — no [B, S] tensors anywhere), and the exact shade /
    accumulate tail shared with the other engines
    (`integrator.advance_from_record`).  This is the function gradients
    flow through.

Gradients agree with the search-based path a.e. (the argmin is piecewise
constant); the primal radiance agrees up to f32 rounding in the winner's
re-intersection (coefficient-form vs direct-form quadratic).

Reference parity: the bounce semantics are RayColor's (kernel.cu:65-98);
intersection math per Sphere.h:29-58 / Quad.h:52-83 / ConstantMedium.h:52-94.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..core import rng
from ..core import vecmath as vm
from ..scene.compiler import SceneArrays
from . import hit as hit_ops
from .hit import BIG, QUAD_PARALLEL_EPS, HitRecord
from .integrator import advance_from_record


def derive_replay(scene: SceneArrays, meta):
    """Merged per-primitive replay table [S+Q, 26]: the winner's geometry
    AND its denormalized material/texture row in ONE row, keyed by the
    tape's GLOBAL prim id.

    One merged row = one row gather per bounce (and one scatter-add in
    the backward) instead of three.  Columns (sphere rows | quad rows):

        0:3   c0            | n_unit
        3:6   dc            | vxw
        6     t0            | wxu.x        7  inv_dt | wxu.y
        8     rad           | wxu.z        9  cth    | q.x
        10    sth           | q.y          11 0      | q.z
        12    mat id (both)
        13:   mat_tab row (kind, fuzz, ior, tex row — `hit.derive` layout)

    The quad re-intersection reads its cols via the quad layout
    (0:3 n_unit, 3:6 vxw, 6:9 wxu, 9:12 q); sphere lanes read the sphere
    layout — each branch's junk on the other kind's rows is select-masked
    exactly as in `hit.assemble_record`.
    """
    der = hit_ops.derive(scene)
    f = der.sph_tab.dtype
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    # sphere geometry block: sph_tab cols 0..10 (c0, dc, t0, inv_dt, rad,
    # cth, sth) + zero pad to 12
    sph_g = jnp.concatenate(
        [der.sph_tab[:, 0:11], jnp.zeros((S, 1), f)], axis=1)
    sph_mid = der.sph_tab[:, 11:12]                       # mat id
    sph_m = der.mat_tab[scene.sph_mat.astype(jnp.int32)]
    rows = [jnp.concatenate([sph_g, sph_mid, sph_m], axis=1)]
    if Q > 0:
        quad_g = der.quad_tab[:, 0:12]   # n_unit, vxw, wxu, q
        quad_mid = der.quad_tab[:, 12:13]
        quad_m = der.mat_tab[scene.quad_mat.astype(jnp.int32)]
        rows.append(jnp.concatenate([quad_g, quad_mid, quad_m], axis=1))
    rep = jnp.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]
    med_rows = None
    if meta.n_media > 0:
        med_rows = der.mat_tab[scene.med_mat.astype(jnp.int32)]
    return rep, med_rows


def taped_record(scene: SceneArrays, meta, rep, med_rows, o, d, time, t_min,
                 u_med, w) -> HitRecord:
    """HitRecord for a KNOWN winner ``w`` [B] i32 (global id, -1 = miss).

    Re-intersects only the winner primitive from its merged replay row
    (ONE row gather per bounce, backward = one scatter-add — see
    `derive_replay`).  The tape is authoritative: no validity re-gating —
    the winner's t is recomputed with the standard NaN-safe guards but its
    hit/miss status comes from ``w`` alone.  Math per Sphere.h:29-58 /
    Quad.h:52-98 / ConstantMedium.h:85-93, identical expression-for-
    expression to `hit.assemble_record`.
    """
    dt = o.dtype
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    NP = S + Q
    hit = w >= 0
    kind = jnp.where(w < S, 0, jnp.where(w < NP, 1, 2))
    idx = jnp.clip(w, 0, NP - 1)
    row = rep[idx]                                # [B, 26] — the ONE read

    # ---- sphere re-intersection (Sphere.h:29-58, direct oc form)
    frac = (time - row[:, 6]) * row[:, 7]
    center = row[:, 0:3] + frac[:, None] * row[:, 3:6]
    rad = row[:, 8]
    oc = o - center
    a = vm.dot(d, d)
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - rad * rad
    disc = b * b - a * c
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))    # NaN-safe at masked lanes
    inv_a = 1.0 / a
    root1 = (-b - sq) * inv_a
    root2 = (-b + sq) * inv_a
    t_sph = jnp.where(root1 > t_min, root1, root2)

    # ---- quad re-intersection (Quad.h:52-64); d_plane recomputed from
    # the row (n_unit . q)
    if Q > 0:
        n_u = row[:, 0:3]
        q_pt = row[:, 9:12]
        d_plane = vm.dot(n_u, q_pt)
        denom = vm.dot(d, n_u)
        dok = jnp.abs(denom) >= QUAD_PARALLEL_EPS
        t_quad = (d_plane - vm.dot(o, n_u)) / \
            jnp.where(dok, denom, 1.0)
    else:
        t_quad = jnp.zeros_like(t_sph)

    t = jnp.where(kind == 0, t_sph, t_quad)
    i_m = jnp.zeros_like(w)
    if meta.n_media > 0:
        # M <= 3 in every reference scene: recompute all medium candidates
        # (identical arithmetic to the tape generator -> identical t) and
        # gather the winner's column.
        i_m = jnp.clip(w - NP, 0, meta.n_media - 1)
        t_m = hit_ops.medium_candidates(scene, o, d, t_min, u_med)
        t_med = jnp.take_along_axis(t_m, i_m[:, None], axis=1)[:, 0]
        t = jnp.where(kind == 2, t_med, t)
    t = jnp.where(hit, t, dt.type(BIG))

    # ---- record assembly (hit.assemble_record semantics, merged row)
    hit_rec = t < dt.type(BIG * 0.5)
    t_safe = jnp.where(hit_rec, t, 1.0)         # see assemble_record notes
    p = o + t_safe[:, None] * d

    # sphere normal/uv (Sphere.h:40-58 + GetSphereUV:74-81)
    n_out_s = (p - center) / jnp.where(rad[:, None] != 0, rad[:, None], 1.0)
    cth, sth = row[:, 9], row[:, 10]
    nx, ny, nz = n_out_s[..., 0], n_out_s[..., 1], n_out_s[..., 2]
    ox_n = cth * nx - sth * nz
    oz_n = sth * nx + cth * nz
    ny_c = jnp.clip(-ny, -1.0, 1.0)
    interior = jnp.abs(ny_c) < 1.0
    theta_uv = jnp.where(interior,
                         jnp.arccos(jnp.where(interior, ny_c, 0.0)),
                         jnp.where(ny_c > 0, 0.0, dt.type(jnp.pi)))
    atan_ok = (jnp.abs(ox_n) + jnp.abs(oz_n)) > 0.0
    phi_uv = jnp.where(
        atan_ok,
        jnp.arctan2(jnp.where(atan_ok, -oz_n, 0.0),
                    jnp.where(atan_ok, ox_n, 1.0)),
        0.0,
    ) + dt.type(jnp.pi)
    u_s = phi_uv / dt.type(2.0 * jnp.pi)
    v_s = theta_uv / dt.type(jnp.pi)

    # quad normal/uv (Quad.h:76-98)
    if Q > 0:
        pq = p - row[:, 9:12]
        alpha = (pq * row[:, 3:6]).sum(-1)
        beta = (pq * row[:, 6:9]).sum(-1)
    else:
        alpha = beta = jnp.zeros_like(u_s)

    is_sph = kind == 0
    n_out = jnp.where(is_sph[:, None], n_out_s, row[:, 0:3])
    uu = jnp.where(is_sph, u_s, alpha)
    vv = jnp.where(is_sph, v_s, beta)
    mat = row[:, 12]
    mrow = row[:, 13:]
    if meta.n_media > 0:
        is_med = kind == 2
        med_normal = jnp.zeros_like(n_out).at[:, 0].set(1.0)
        n_out = jnp.where(is_med[:, None], med_normal, n_out)
        uu = jnp.where(is_med, 0.0, uu)
        vv = jnp.where(is_med, 0.0, vv)
        mat = jnp.where(is_med, scene.med_mat[i_m].astype(mat.dtype), mat)
        mrow = jnp.where(is_med[:, None],
                         med_rows[i_m], mrow)

    front = vm.dot(d, n_out) < 0.0
    normal = jnp.where(front[:, None], n_out, -n_out)
    if meta.n_media > 0:
        front = jnp.where(is_med, True, front)
        normal = jnp.where(is_med[:, None], n_out, normal)

    return HitRecord(t=t, p=p, normal=normal, u=uu, v=vv, front=front,
                     mat=mat.astype(jnp.int32), hit=hit_rec, mrow=mrow)


def _u_med(meta, pix_ctr, samp, bounce, dtype):
    """Per-(ray, medium) uniforms, bounce_step's draw layout exactly."""
    med_slots = jnp.arange(max(meta.n_media, 1), dtype=jnp.uint32)[None, :]
    stream = jnp.uint32(rng.MEDIUM_STREAM) | jnp.asarray(bounce, jnp.uint32)
    return rng.uniform_open4(
        pix_ctr[:, None], samp[..., None], stream, med_slots,
        float_dtype=dtype,
    )[0]


def generate_tape(scene: SceneArrays, meta, o, d, time, pix_ctr, sample, *,
                  max_bounces: int, t_min: float, hit_winner_fn=None):
    """Run the bounce loop once and record winners.

    Returns ``(tape [max_bounces, B] i32, radiance [B, 3])`` — the radiance
    is the search path's primal, used by tests to cross-check the replay.
    ``hit_winner_fn(o, d, time, t_min, u_med) -> (HitRecord, w)`` swaps the
    winner-producing engine (defaults to the XLA closest hit).
    """
    dtype = o.dtype
    B = o.shape[0]
    der = hit_ops.derive(scene)
    samp = jnp.asarray(sample, jnp.uint32)
    if hit_winner_fn is None:
        def hit_winner_fn(o, d, time, tm, u_med):
            return hit_ops.closest_hit_winner(
                scene, meta, der, o, d, time, tm, u_med)

    def body(carry, bounce):
        o, d, thr, acc, alive = carry
        u_med = _u_med(meta, pix_ctr, samp, bounce, dtype)
        rec, w = hit_winner_fn(o, d, time, dtype.type(t_min), u_med)
        w = jnp.where(alive, w, -1)
        carry = advance_from_record(
            scene, meta, rec, o, d, thr, acc, alive, pix_ctr, samp, bounce)
        return carry, w

    init = (o, d, jnp.ones((B, 3), dtype), jnp.zeros((B, 3), dtype),
            jnp.ones((B,), bool))
    (_, _, _, acc, _), tape = lax.scan(
        body, init, jnp.arange(max_bounces))
    return tape, acc


def replay(scene: SceneArrays, meta, tape, o, d, time, pix_ctr, sample, *,
           max_bounces: int, t_min: float):
    """Radiance [B,3] with the per-bounce winners fixed by ``tape`` — the
    differentiable leg of the taped path (O(1) work per segment)."""
    dtype = o.dtype
    B = o.shape[0]
    rep, med_rows = derive_replay(scene, meta)
    samp = jnp.asarray(sample, jnp.uint32)

    def body(carry, xs):
        bounce, w = xs
        o, d, thr, acc, alive = carry
        u_med = _u_med(meta, pix_ctr, samp, bounce, dtype)
        rec = taped_record(scene, meta, rep, med_rows, o, d, time,
                           dtype.type(t_min), u_med, w)
        carry = advance_from_record(
            scene, meta, rec, o, d, thr, acc, alive, pix_ctr, samp, bounce)
        return carry, None

    init = (o, d, jnp.ones((B, 3), dtype), jnp.zeros((B, 3), dtype),
            jnp.ones((B,), bool))
    (_, _, _, acc, _), _ = lax.scan(
        body, init, (jnp.arange(max_bounces), tape))
    return acc


def trace_taped(scene: SceneArrays, meta, o, d, time, pix_ctr, sample, *,
                max_bounces: int, t_min: float, hit_winner_fn=None):
    """Drop-in differentiable radiance: tape once (non-diff — the tape is
    integer-valued, so autodiff prunes its producer from the backward), then
    replay differentiably.  Same signature semantics as
    `integrator.trace(differentiable=True)` and ~O(S) cheaper per bounce in
    the backward."""
    tape, _ = generate_tape(
        scene, meta, lax.stop_gradient(o), lax.stop_gradient(d),
        lax.stop_gradient(time), pix_ctr, sample,
        max_bounces=max_bounces, t_min=t_min, hit_winner_fn=hit_winner_fn)
    tape = lax.stop_gradient(tape)
    return replay(scene, meta, tape, o, d, time, pix_ctr, sample,
                  max_bounces=max_bounces, t_min=t_min)
