"""Closest-hit over the SoA scene: the data-parallel replacement for the
reference's virtual-dispatch hit chain (BvhNode::Hit -> leaf Hit,
BvhNode.h:101-158, Sphere.h:22-63, MovingSphere.h:44-89, Quad.h:52-83,
ConstantMedium.h:52-94).

Design: instead of a per-ray pointer walk, every ray tests every primitive
*by type* with branchless arithmetic, and a masked argmin picks the winner.
The quadratic/plane coefficients for all (ray, primitive) pairs factor into
[B,3] x [3,N] contractions with zero divergence — plus elementwise
selects.  This is the plain reference engine; a BVH engine exists
separately (`ops/bvh_engine.py`) for the reference's BVH-equivalence
milestone and for large worlds, and the megakernel (`ops/mega2.py`) is the
fast path.

Gather discipline: everything the winner lookup needs is packed into one
row-matrix per primitive type (`Derived`), making record assembly +
shading one row-gather each instead of ~10 scalar gathers.

Closest-hit equivalence with the reference's shrinking-tMax list walk
(HittableList.h:39-57): per primitive we produce the *nearest root beyond
t_min* and let the argmin impose the upper bound — a candidate past the
closest hit loses the argmin exactly when the reference's range test would
have rejected it.  The same argument covers the stochastic medium candidate
(clipping exit-t by closest before the scatter draw vs. comparing after are
the same event: scatter point < min(exit, closest)).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.compiler import MED_BOX, SceneArrays

BIG = 1.0e30
MEDIUM_REHIT_EPS = 1.0e-4  # ConstantMedium.h:63
QUAD_PARALLEL_EPS = 1.0e-8  # Quad.h:59

# sphere record row: c0(3) dc(3) t0 inv_dt rad cos sin mat
SPH_ROW = 12
# quad record row: n_unit(3) vxw(3) wxu(3) q(3) mat
QUAD_ROW = 13
# material/texture row (texture denormalized into the material):
#   kind fuzz ior tex_kind c0(3) c1(3) inv_scale scale noise_id image_id
MAT_ROW = 14


class HitRecord(NamedTuple):
    """Batched analogue of the reference HitRecord (Hittable.h:11-31).

    ``mrow`` carries the winner's packed material/texture row so shading
    never re-gathers (mat id itself is column-free here).
    """

    t: jnp.ndarray        # [B]
    p: jnp.ndarray        # [B,3]
    normal: jnp.ndarray   # [B,3] (front-faced, SetFaceNormal semantics)
    u: jnp.ndarray        # [B]
    v: jnp.ndarray        # [B]
    front: jnp.ndarray    # [B] bool
    mat: jnp.ndarray      # [B] i32
    hit: jnp.ndarray      # [B] bool
    mrow: jnp.ndarray     # [B, MAT_ROW]


class Derived(NamedTuple):
    """Per-scene quantities derived in-graph (so gradients flow to the
    primal SoA columns) and packed for single-row-gather lookups."""

    ds: dict              # per-sphere candidate scalars
    dq: dict              # per-quad plane constants
    sph_tab: jnp.ndarray  # [S, SPH_ROW]
    quad_tab: jnp.ndarray  # [Q, QUAD_ROW]
    mat_tab: jnp.ndarray  # [K, MAT_ROW]


def derive_spheres(s: SceneArrays):
    """Per-sphere scalars reused across bounces (computed in-graph so
    gradients flow to the primal columns)."""
    return dict(
        c0_sq=(s.sph_c0 * s.sph_c0).sum(-1),
        c0_dc=(s.sph_c0 * s.sph_dc).sum(-1),
        dc_sq=(s.sph_dc * s.sph_dc).sum(-1),
        rad_sq=s.sph_rad * s.sph_rad,
    )


def derive_quads(s: SceneArrays):
    """Plane constants the reference caches at construction (Quad.h:31-37),
    plus the triple-product vectors that turn the interior test into two
    ray-independent contractions:
        alpha = w . (pvec x v) = pvec . (v x w)
        beta  = w . (u x pvec) = pvec . (w x u)
    """
    n = vm.cross(s.quad_u, s.quad_v)
    n_len = vm.length(n)[..., None]
    n_unit = n / jnp.where(n_len > 0, n_len, 1.0)
    d_plane = vm.dot(n_unit, s.quad_q)
    w_vec = n / jnp.where((n * n).sum(-1, keepdims=True) > 0, (n * n).sum(-1, keepdims=True), 1.0)
    vxw = vm.cross(s.quad_v, w_vec)
    wxu = vm.cross(w_vec, s.quad_u)
    return dict(
        n_unit=n_unit,
        d_plane=d_plane,
        vxw=vxw,
        wxu=wxu,
        q_vxw=vm.dot(s.quad_q, vxw),
        q_wxu=vm.dot(s.quad_q, wxu),
    )


def derive(s: SceneArrays) -> Derived:
    """Build all in-graph derived state (called once per traced program;
    loop-invariant, so XLA hoists it out of the bounce loop)."""
    f = jnp.asarray(s.sph_rad).dtype
    ds = derive_spheres(s)
    dq = derive_quads(s)
    asf = lambda a: jnp.asarray(a, f)
    col = lambda a: asf(a)[:, None]
    sph_tab = jnp.concatenate(
        [asf(s.sph_c0), asf(s.sph_dc), col(s.sph_t0), col(s.sph_inv_dt),
         col(s.sph_rad), col(s.sph_cos), col(s.sph_sin), col(s.sph_mat)],
        axis=1,
    )
    quad_tab = jnp.concatenate(
        [dq["n_unit"], dq["vxw"], dq["wxu"], asf(s.quad_q), col(s.quad_mat)],
        axis=1,
    )
    mat_tab = jnp.concatenate(
        [col(s.mat_kind), col(s.mat_fuzz), col(s.mat_ior)], axis=1
    )
    # denormalize each material's texture into its row (every material has
    # at most one texture; checker children are solid colors by scene
    # grammar — kernel.cu:203-206,263-266)
    tid = jnp.clip(s.mat_tex, 0, s.tex_kind.shape[0] - 1)
    tex_cols = jnp.concatenate(
        [col(s.tex_kind)[tid], asf(s.tex_c0)[tid], asf(s.tex_c1)[tid],
         col(s.tex_inv_scale)[tid], col(s.tex_scale)[tid],
         col(s.tex_noise)[tid], col(s.tex_image)[tid]],
        axis=1,
    )
    mat_tab = jnp.concatenate([mat_tab, tex_cols], axis=1)
    return Derived(ds=ds, dq=dq, sph_tab=sph_tab, quad_tab=quad_tab,
                   mat_tab=mat_tab)


def sphere_candidates(s: SceneArrays, ds, o, d, time, t_min):
    """Nearest valid quadratic root per (ray, sphere): [B,S] t (BIG = none).

    Math per Sphere.h:29-33 / MovingSphere.h:52-58 (half-b convention), with
    the moving-sphere center lerp folded into the coefficients so the pair
    matrix never materializes in 3-vector form:
        center(t) = c0 + frac * dc,  frac = (ray.time - t0) * inv_dt
        d.center  = d@c0 + frac * d@dc      (two [B,3]x[3,S] contractions)
        o.center  = o@c0 + frac * o@dc
        |center|^2 = |c0|^2 + 2 frac (c0.dc) + frac^2 |dc|^2
    """
    dt = o.dtype
    frac = (time[:, None] - s.sph_t0[None, :]) * s.sph_inv_dt[None, :]
    # HIGHEST is load-bearing: a reduced-precision f32 matmul (TF32 on
    # the GPU keeps ~10 mantissa bits) gives the o/c0-scale products an
    # absolute error (~|o||c0|*2^-10) that rivals r^2 for small spheres,
    # shrinking them and darkening the frame.  HIGHEST keeps full f32
    # products; CPU bits are unchanged.
    hp = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=hp)
    d_c0 = mm(d, s.sph_c0.T)
    o_c0 = mm(o, s.sph_c0.T)
    d_dc = mm(d, s.sph_dc.T)
    o_dc = mm(o, s.sph_dc.T)
    a = vm.dot(d, d)[:, None]
    o_sq = vm.dot(o, o)[:, None]
    o_d = vm.dot(o, d)[:, None]

    d_center = d_c0 + frac * d_dc
    o_center = o_c0 + frac * o_dc
    center_sq = ds["c0_sq"][None, :] + frac * (2.0 * ds["c0_dc"][None, :] + frac * ds["dc_sq"][None, :])

    b = o_d - d_center                      # Dot(oc, dir)
    c = o_sq - 2.0 * o_center + center_sq - ds["rad_sq"][None, :]
    disc = b * b - a * c
    # NaN-safe sqrt: sqrt'(0) is inf, and masked-out lanes (disc <= 0,
    # e.g. the degenerate padding rows) would contribute 0 x inf = NaN in
    # reverse mode; the forward image is unchanged (ok masks these lanes).
    pos = disc > 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    inv_a = 1.0 / a
    root1 = (-b - sq) * inv_a
    root2 = (-b + sq) * inv_a
    feasible = pos & s.sph_active[None, :]
    t_cand = jnp.where(root1 > t_min, root1, root2)   # nearest root beyond t_min
    ok = feasible & (t_cand > t_min)                  # strict, Sphere.h:38
    return jnp.where(ok, t_cand, dt.type(BIG))


def quad_candidates(s: SceneArrays, dq, o, d, t_min):
    """Plane-hit + interior test per (ray, quad): [B,S] t (Quad.h:52-99)."""
    dt = o.dtype
    # HIGHEST for the same reason as sphere_candidates: cornell-scale
    # coordinates (~555) against ~1/555-scale plane frames would lose the
    # (alpha, beta) interior coordinates' low bits to TF32 rounding.
    hp = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=hp)
    denom = mm(d, dq["n_unit"].T)                     # [B,Q]
    denom_ok = jnp.abs(denom) >= QUAD_PARALLEL_EPS
    denom_safe = jnp.where(denom_ok, denom, 1.0)
    t = (dq["d_plane"][None, :] - mm(o, dq["n_unit"].T)) / denom_safe
    alpha = (mm(o, dq["vxw"].T) + t * mm(d, dq["vxw"].T)
             - dq["q_vxw"][None, :])
    beta = (mm(o, dq["wxu"].T) + t * mm(d, dq["wxu"].T)
            - dq["q_wxu"][None, :])
    ok = (
        s.quad_active[None, :]
        & denom_ok
        & (t >= t_min)                                 # inclusive, Quad.h:64
        & (alpha >= 0.0) & (alpha <= 1.0)              # Interval::Contains
        & (beta >= 0.0) & (beta <= 1.0)
    )
    return jnp.where(ok, t, dt.type(BIG))


def medium_candidates(s: SceneArrays, o, d, t_min, u_med):
    """Stochastic scatter-point per (ray, medium): [B,M] t (ConstantMedium.h:52-94).

    Boundary entry/exit computed analytically: quadratic roots for sphere
    boundaries, slab interval for (instanced) box boundaries — identical t
    values to the reference's two sequential boundary Hit calls over
    (-inf, inf), including the +1e-4 re-hit epsilon.
    ``u_med`` is the per-(ray, medium) uniform in (0,1].
    """
    dt = o.dtype
    # sphere boundary roots
    oc = o[:, None, :] - s.med_center[None, :, :]          # [B,M,3] (M tiny)
    a = vm.dot(d, d)[:, None]
    b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - (s.med_radius * s.med_radius)[None, :]
    disc = b * b - a * c
    valid_s = disc > 0.0
    sq = jnp.sqrt(jnp.where(valid_s, disc, 1.0))  # NaN-safe (see above)
    t0_s = (-b - sq) / a
    t1_s = (-b + sq) / a

    # box boundary: world->object rigid transform, then slab test
    cth = s.med_cos[None, :, None]
    sth = s.med_sin[None, :, None]
    po = o[:, None, :] - s.med_off[None, :, :]
    ox, oy, oz = po[..., 0], po[..., 1], po[..., 2]
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    c2, s2 = cth[..., 0], sth[..., 0]
    o_obj = jnp.stack(jnp.broadcast_arrays(c2 * ox - s2 * oz, oy, s2 * ox + c2 * oz), -1)
    d_obj = jnp.stack(jnp.broadcast_arrays(c2 * dx - s2 * dz, dy, s2 * dx + c2 * dz), -1)
    inv_d = 1.0 / d_obj
    ta = (s.med_bmin[None] - o_obj) * inv_d
    tb = (s.med_bmax[None] - o_obj) * inv_d
    t0_b = jnp.minimum(ta, tb).max(-1)
    t1_b = jnp.maximum(ta, tb).min(-1)
    valid_b = t1_b > t0_b

    is_box = (s.med_kind == MED_BOX)[None, :]
    t0 = jnp.where(is_box, t0_b, t0_s)
    t1 = jnp.where(is_box, t1_b, t1_s)
    valid = jnp.where(is_box, valid_b, valid_s) & s.med_active[None, :]
    valid &= t1 > t0 + dt.type(MEDIUM_REHIT_EPS)

    t0c = jnp.maximum(jnp.maximum(t0, t_min), 0.0)     # clip entry (h:67,73-74)
    valid &= t0c < t1
    ray_len = jnp.sqrt(a)
    dist_inside = (t1 - t0c) * ray_len
    hit_dist = s.med_nid[None, :] * jnp.log(u_med)     # -(1/rho) log U, h:79
    valid &= hit_dist <= dist_inside
    t_cand = t0c + hit_dist / ray_len
    return jnp.where(valid, t_cand, dt.type(BIG))


def first_argmin(t, t_best):
    """Index of the first occurrence of ``t_best`` along the last axis.

    Bit-identical to ``argmin`` (first-min tie rule) but lowers as a plain
    int min-reduce instead of XLA's variadic (value, index) reduction."""
    n = t.shape[-1]
    iota = jnp.arange(n, dtype=jnp.int32)
    return jnp.min(jnp.where(t == t_best[..., None], iota, n), -1)


def closest_hit(scene: SceneArrays, meta, der: Derived, o, d, time, t_min, u_med):
    """Full-world closest hit -> HitRecord (the (*world)->Hit call of the
    integrator, kernel.cu:74)."""
    rec, _ = closest_hit_winner(scene, meta, der, o, d, time, t_min, u_med)
    return rec


def closest_hit_winner(scene: SceneArrays, meta, der: Derived, o, d, time,
                       t_min, u_med):
    """`closest_hit` that also returns the winner's GLOBAL id [B] i32:
    sphere rows [0,S), quads [S,S+Q), media [S+Q,S+Q+M), -1 = miss — the
    per-bounce tape entry of the taped-replay differentiable path
    (`ops/replay.py`)."""
    t_s = sphere_candidates(scene, der.ds, o, d, time, t_min)
    t_q = quad_candidates(scene, der.dq, o, d, t_min)
    ts_best = t_s.min(-1)
    is_best = first_argmin(t_s, ts_best)
    tq_best = t_q.min(-1)
    iq_best = first_argmin(t_q, tq_best)

    parts_t = [ts_best, tq_best]
    im_best = jnp.zeros_like(is_best)
    if meta.n_media > 0:
        t_m = medium_candidates(scene, o, d, t_min, u_med)
        parts_t.append(t_m.min(-1))
        im_best = t_m.argmin(-1)

    t_all = jnp.stack(parts_t, 0)          # [3?,B]
    kind = t_all.argmin(0)
    t = t_all.min(0)
    rec = assemble_record(scene, meta, der, o, d, time, t, kind,
                          is_best, iq_best, im_best)
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]
    w = jnp.where(kind == 0, is_best, S + iq_best)
    if meta.n_media > 0:
        w = jnp.where(kind == 2, S + Q + im_best, w)
    w = jnp.where(rec.hit, w, -1)
    return rec, w.astype(jnp.int32)


def record_from_geo_winner(scene: SceneArrays, meta, der: Derived, o, d, time,
                           t_min, u_med, t_geo, best_p) -> HitRecord:
    """Merge a geometry winner (global prim id ``best_p``, -1 = none; sphere
    rows first, then quads) with the stochastic media candidates and build
    the HitRecord.  Shared tail of the BVH and Pallas engines."""
    dt = o.dtype
    B = o.shape[0]
    S = scene.sph_c0.shape[0]
    t_geo = jnp.where(best_p >= 0, t_geo, dt.type(BIG))
    kind_geo = jnp.where(best_p >= S, 1, 0)
    parts_t = [jnp.where(kind_geo == 0, t_geo, dt.type(BIG)),
               jnp.where(kind_geo == 1, t_geo, dt.type(BIG))]
    im_best = jnp.zeros(B, jnp.int32)
    if meta.n_media > 0:
        t_m = medium_candidates(scene, o, d, t_min, u_med)
        parts_t.append(t_m.min(-1))
        im_best = t_m.argmin(-1)
    t_all = jnp.stack(parts_t, 0)
    kind = t_all.argmin(0)
    t = t_all.min(0)
    i_s = jnp.clip(best_p, 0, S - 1)
    i_q = jnp.clip(best_p - S, 0, scene.quad_q.shape[0] - 1)
    return assemble_record(scene, meta, der, o, d, time, t, kind,
                           i_s, i_q, im_best)


def assemble_record(scene: SceneArrays, meta, der: Derived, o, d, time, t,
                    kind, is_best, iq_best, im_best) -> HitRecord:
    """Winner (t, kind, per-type index) -> full HitRecord.

    ``kind``: 0 = sphere, 1 = quad, 2 = constant medium; a ``t`` >= BIG/2
    means no hit.  One packed row-gather per primitive type + one for the
    winner material (Sphere.h:40-58, Quad.h:76-98, ConstantMedium.h:85-93).
    """
    read = lambda tab, idx: tab[idx]
    dt = o.dtype
    hit = t < dt.type(BIG * 0.5)
    # Sanitize miss lanes: t = BIG would put p at ~1e30, which overflows the
    # all-lanes material math downstream (f32 inf) — harmless forward (the
    # integrator masks on `hit`) but fatal in reverse mode, where an inf
    # primal times a masked-zero cotangent is NaN and poisons every
    # upstream gradient.
    t_safe = jnp.where(hit, t, 1.0)
    p = o + t_safe[:, None] * d

    # ---- sphere record (Sphere.h:40-58 + GetSphereUV:74-81)
    srow = read(der.sph_tab, is_best)       # [B, SPH_ROW] one gather
    c0, dc = srow[:, 0:3], srow[:, 3:6]
    frac = (time - srow[:, 6]) * srow[:, 7]
    center = c0 + frac[:, None] * dc
    rad = srow[:, 8:9]
    n_out_s = (p - center) / jnp.where(rad != 0, rad, 1.0)
    # UV from the object-space normal (instanced spheres keep their frame)
    cth, sth = srow[:, 9], srow[:, 10]
    nx, ny, nz = n_out_s[..., 0], n_out_s[..., 1], n_out_s[..., 2]
    ox_n = cth * nx - sth * nz
    oz_n = sth * nx + cth * nz
    # NaN-safe UV: arccos'(+-1) and arctan2 at (0,0) are infinite, and an
    # unused-branch zero cotangent times inf is NaN in reverse mode — feed
    # the nonlinearities safe inputs and select the exact pole constants.
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
    mat_s = srow[:, 11]

    # ---- quad record (Quad.h:76-98)
    qrow = read(der.quad_tab, iq_best)      # [B, QUAD_ROW] one gather
    n_q = qrow[:, 0:3]
    pq = p - qrow[:, 9:12]
    alpha = (pq * qrow[:, 3:6]).sum(-1)
    beta = (pq * qrow[:, 6:9]).sum(-1)
    mat_q = qrow[:, 12]

    # ---- assemble by kind
    is_sph = kind == 0
    n_out = jnp.where(is_sph[:, None], n_out_s, n_q)
    uu = jnp.where(is_sph, u_s, alpha)
    vv = jnp.where(is_sph, v_s, beta)
    mat = jnp.where(is_sph, mat_s, mat_q)
    if meta.n_media > 0:
        is_med = kind == 2
        med_normal = jnp.zeros_like(n_out).at[:, 0].set(1.0)  # arbitrary, h:89
        n_out = jnp.where(is_med[:, None], med_normal, n_out)
        uu = jnp.where(is_med, 0.0, uu)
        vv = jnp.where(is_med, 0.0, vv)
        mat = jnp.where(is_med, scene.med_mat[im_best].astype(mat.dtype), mat)

    front = vm.dot(d, n_out) < 0.0          # SetFaceNormal, Hittable.h:24-30
    normal = jnp.where(front[:, None], n_out, -n_out)
    if meta.n_media > 0:
        front = jnp.where(is_med, True, front)        # arbitrary true, h:90
        normal = jnp.where(is_med[:, None], n_out, normal)

    mat_i = mat.astype(jnp.int32)
    mrow = read(der.mat_tab, mat_i)         # [B, MAT_ROW] one gather
    return HitRecord(t=t, p=p, normal=normal, u=uu, v=vv, front=front,
                     mat=mat_i, hit=hit, mrow=mrow)
