"""Pixel-per-lane path-tracing megakernel for NVIDIA GPUs (Pallas, Triton
route) — the render fast path and the winner-tape producer of the train
step.

The design is the reference's own (`kernel.cu:122-154`): one lane per pixel,
each lane runs its whole sample loop and its <=50-bounce `RayColor` loop
(`kernel.cu:65-98`) in registers, with its own RNG counter, and there is no
per-bounce round trip through device memory.  One program owns a 1-D block
of ``LANES`` pixel lanes and runs a block-level `while_loop` until every
lane has finished its samples:

  * **Sample-sequential refill.**  When a path terminates, its radiance
    joins the lane's pixel sum and the next camera ray of the SAME pixel is
    generated in-kernel (pure counter RNG, closed-form camera), so lane work
    is the sum of spp path lengths and relative tail waste shrinks with spp.
  * **Pair test.**  Primitives are tested in ``[LANES, PAIR_C]`` tiles
    (the exact direct sphere quadratic, the quad plane + interior test, one
    slab test per axis-aligned box) with a masked min per tile.  Tiles are
    grouped into Morton chunks of ``CHUNK`` primitives; worlds with more
    than ``CULL_MIN_PRIMS`` pair-tested rows skip a chunk whose AABB no live
    lane's ray meets within its current ``(t_min, t_best)`` interval — a
    block-level `cond`, exact either way (AABB.h:68-98).
  * **Tables stay in global memory** (L2-resident at reference sizes): the
    winner's attributes, Perlin lattice entries and image texels are read
    with one indexed load each.

RNG keys, draw layout and bounce semantics are those of the XLA engines
(`core/rng.py`; kernel.cu:65-98: a miss adds throughput x background and
terminates, emission adds on every hit, no scatter terminates, the bounce
cap adds nothing), so per-(pixel, sample) radiance matches the chunked
engine up to f32 winner ties, and each pixel's samples are summed in the
same order as the chunked engine's sample loop (tests/test_mega2.py).

Scene features are static (`SceneMeta`): scenes without quads, boxes,
media, checker, noise, image textures or moving spheres compile none of
that code.  The trace mode (one sample per lane, fixed depth) writes the
winner id of every bounce for `ops/replay.py`.

Reference parity: sphere/quad/media tests kernel.cu:65-98, Sphere.h:22-63,
Quad.h:52-99, ConstantMedium.h:52-94; camera Camera.h:76-85; materials
Material.h / Metal.h / Dielectric.h; textures Texture.h.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import rng as rnglib
from ..scene.compiler import (
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN,
    MAT_METAL, MED_BOX, SceneArrays, SceneMeta, TEX_CHECKER, TEX_IMAGE,
    TEX_NOISE,
)
from ..utils.config import RenderConfig
from .backend import PALLAS_BACKEND, pallas_interpret

BIG = 1.0e30
LANES = 64         # pixel lanes per program (a power of two)
NUM_WARPS = 2      # LANES // 32: one lane per thread
PAIR_C = 8         # primitives per [LANES, PAIR_C] pair-test tile
CHUNK = 64         # primitives per Morton chunk (the culling granule)
# Pair-tested rows (spheres + loose quads + boxes) above which chunk culling
# engages.  Every reference scene is below it.
CULL_MIN_PRIMS = 2048

SPH_COLS = 16      # 0:3 c0, 3:6 dc, 6 t0, 7 inv_dt, 8 rad, 10 rad^2
                   # (padding rows: rad^2 = -1, so disc < 0 and they never win)
QUAD_COLS = 16     # 0:3 n_unit, 3 D, 4:7 vxw, 7 q.vxw, 8:11 wxu, 11 q.wxu
BOX_COLS = 8       # 0:3 bmin, 3:6 bmax, 6 local quad row of face 0, 7 active
CULL_COLS = 8      # 0:3 chunk AABB lo, 3:6 hi
ATTR_COLS = 40     # 0:3 c0|n_unit, 3:6 dc|0, 6 t0, 7 inv_dt, 8 rad, 9 is_quad,
                   # 10 kind, 11 fuzz, 12 ior, 13 tex_kind, 14:17 tc0, 17:20 tc1,
                   # 20 inv_scale, 21 uv_cos, 22 uv_sin, 23 tex_scale(noise),
                   # 24 img_id, 25 noise_id, 32:35 vxw, 35 q.vxw, 36:39 wxu,
                   # 39 q.wxu (quad rows only — the (alpha,beta) UV frame,
                   # Quad.h:31-37; cols 3:8 stay 0 for quads so the
                   # moving-sphere winner-center path reads c0 + frac*0)


class Mega2Layout(NamedTuple):
    """Static (hashable) facts of a packed table set — a jit key."""
    s_pad: int          # sphere rows (a CHUNK multiple)
    nl_pad: int         # loose (pair-tested) quad rows (a CHUNK multiple)
    q_pad: int          # attr quad rows: loose, boxed faces, padding
    b_pad: int          # box slab rows (a CHUNK multiple)
    img_dims: tuple     # per image (iw, ih, flat texel offset)

    @property
    def n_geo(self) -> int:
        """Kernel geometry rows; medium m reports winner id n_geo + m."""
        return self.s_pad + self.q_pad

    @property
    def pair_rows(self) -> int:
        return self.s_pad + self.nl_pad + self.b_pad


class Mega2Tables(NamedTuple):
    """Device arrays of the kernel's scene tables."""
    sph: jax.Array      # [SPH_COLS, s_pad] f32
    quad: jax.Array     # [QUAD_COLS, max(nl_pad, CHUNK)] f32
    box: jax.Array      # [BOX_COLS, max(b_pad, CHUNK)] f32
    cull: jax.Array     # [CULL_COLS, n_chunks] f32 (spheres, quads, boxes)
    attr: jax.Array     # [(n_geo + 1) * ATTR_COLS] f32, last row zero
    perm: jax.Array     # [3 * 256 * n_noise] i32 (px, py, pz per table)
    vec: jax.Array      # [3 * 256 * n_noise] f32 (vx, vy, vz per table)
    img: jax.Array      # [sum iw*ih] i32 texels (r<<16 | g<<8 | b)


def _mat_cols(scene: SceneArrays, mat_ids: np.ndarray) -> np.ndarray:
    """[n, 16] material+texture parameter columns (attr cols 10..25)."""
    s = scene
    tid = np.clip(np.asarray(s.mat_tex)[mat_ids], 0, s.tex_kind.shape[0] - 1)
    has_img = np.asarray(s.mat_tex)[mat_ids] >= 0
    img_id = np.where(has_img, np.asarray(s.tex_image)[tid], -1)
    cols = np.stack([
        np.asarray(s.mat_kind, np.float64)[mat_ids],
        np.asarray(s.mat_fuzz, np.float64)[mat_ids],
        np.asarray(s.mat_ior, np.float64)[mat_ids],
        np.asarray(s.tex_kind, np.float64)[tid],
        *[np.asarray(s.tex_c0, np.float64)[tid][:, i] for i in range(3)],
        *[np.asarray(s.tex_c1, np.float64)[tid][:, i] for i in range(3)],
        np.asarray(s.tex_inv_scale, np.float64)[tid],
        np.zeros(len(mat_ids)),                      # uv_cos placeholder
        np.zeros(len(mat_ids)),                      # uv_sin placeholder
        np.asarray(s.tex_scale, np.float64)[tid],
        np.asarray(img_id, np.float64),
        np.asarray(s.tex_noise, np.float64)[tid],
    ], axis=1)
    return cols


def _morton(p: np.ndarray) -> np.ndarray:
    """30-bit Morton code of points [n,3] quantized over their bbox."""
    if p.shape[0] == 0:
        return np.zeros(0, np.int64)
    lo = p.min(0)
    ext = np.maximum(p.max(0) - lo, 1e-12)
    q = np.clip(((p - lo) / ext * 1023.0).astype(np.int64), 0, 1023)
    code = np.zeros(p.shape[0], np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def _sphere_order(c0, dc, rad):
    """Cull-friendly primitive order: oversized spheres first (most rays hit
    them, so testing them first tightens t_best before the spatial chunks
    are considered), then Morton order for chunk locality."""
    n = c0.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    med = np.median(rad) if n > 4 else 0.0
    big = rad > max(10.0 * med, 1e-9)
    return np.lexsort((_morton(c0 + 0.5 * dc), ~big))


def _detect_boxes(qact_idx, q_all, u_all, v_all):
    """Axis-aligned box groups among the active quads: six CONSECUTIVE
    rows exactly matching the scene compiler's `_box_quads` face pattern
    (front,right,back,left,top,bottom; the in-kernel face offsets depend on
    this order).  Rotated MakeBox instances (scenes 7/8) have rotated u/v,
    fail the exact-equality check and stay on the quad pair path.
    Returns a list of (orig_ids[6], bmin[3], bmax[3])."""
    out = []
    j = 0
    idx = np.asarray(qact_idx)
    while j + 6 <= len(idx):
        ids = idx[j:j + 6]
        if not np.array_equal(ids, ids[0] + np.arange(6)):
            j += 1
            continue
        mn = q_all[ids[5]]
        ext = np.array([u_all[ids[5]][0], v_all[ids[0]][1],
                        v_all[ids[5]][2]])
        if not np.all(ext > 0.0):
            j += 1
            continue
        mx = mn + ext
        w = np.array([ext[0], 0.0, 0.0])
        h = np.array([0.0, ext[1], 0.0])
        d = np.array([0.0, 0.0, ext[2]])
        want_q = np.stack([
            [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
            [mx[0], mn[1], mn[2]], [mn[0], mn[1], mn[2]],
            [mn[0], mx[1], mx[2]], [mn[0], mn[1], mn[2]]])
        want_u = np.stack([w, -d, -w, d, w, w])
        want_v = np.stack([h, h, h, h, -d, d])
        if (np.array_equal(q_all[ids], want_q)
                and np.array_equal(u_all[ids], want_u)
                and np.array_equal(v_all[ids], want_v)):
            out.append((ids, mn, mx))
            j += 6
        else:
            j += 1
    return out


def _chunk_boxes(lo: np.ndarray, hi: np.ndarray, n_pad: int) -> np.ndarray:
    """Per-CHUNK AABBs [n_pad // CHUNK, 6] of per-row boxes lo/hi [n, 3];
    empty chunks get a far-away point box that every slab test misses."""
    n_ch = n_pad // CHUNK
    out = np.full((n_ch, 6), 1.0e30)
    for c in range(n_ch):
        rows = slice(c * CHUNK, min((c + 1) * CHUNK, lo.shape[0]))
        if c * CHUNK < lo.shape[0]:
            out[c, 0:3] = lo[rows].min(0)
            out[c, 3:6] = hi[rows].max(0)
    return out


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _texture_arrays(scene: SceneArrays, meta: SceneMeta):
    """Perlin permutation / gradient rows and the packed image texels."""
    n_noise = max(meta.n_noise, 1)
    perm = np.zeros((n_noise, 3, 256), np.int32)
    vec = np.zeros((n_noise, 3, 256), np.float32)
    if meta.has_noise:
        for t in range(meta.n_noise):
            perm[t, 0] = np.asarray(scene.perlin_px)[t]
            perm[t, 1] = np.asarray(scene.perlin_py)[t]
            perm[t, 2] = np.asarray(scene.perlin_pz)[t]
            vec[t] = np.asarray(scene.perlin_vec, np.float32)[t].T
    dims, planes, off = [], [], 0
    if meta.has_image:
        ws, hs = np.asarray(scene.img_w), np.asarray(scene.img_h)
        for i in range(meta.n_images):
            iw, ih = int(ws[i]), int(hs[i])
            img = np.asarray(scene.img_data, np.float64)[i][:ih, :iw]
            # img_data holds byte/255 exactly (core/image.py); the three
            # bytes pack into one i32 per texel, one load per lookup
            b = np.clip(np.round(img * 255.0), 0, 255).astype(np.int64)
            planes.append(((b[..., 0] << 16) | (b[..., 1] << 8)
                           | b[..., 2]).astype(np.int32).reshape(-1))
            dims.append((iw, ih, off))
            off += iw * ih
    img = np.concatenate(planes) if planes else np.zeros(1, np.int32)
    return perm.reshape(-1), vec.reshape(-1), img, tuple(dims)


def pack_mega2_tables(scene: SceneArrays, meta: SceneMeta):
    """Host-side packing -> (Mega2Tables, Mega2Layout, med [M, 22] numpy,
    remap [n_geo + M] i32: kernel row -> GLOBAL scene id, -1 for padding).

    Spheres are reordered (big-first + Morton) and padded to CHUNK rows.
    Axis-aligned box groups (Instance.h:166-184 MakeBox with no RotateY)
    are hoisted out of the quad pair test into a box table: ONE slab test
    per box replaces six plane+interior tests (400 ground boxes are 2400 of
    the final scene's 2432 quads).  A box winner reports its hit face's
    quad row, so the attr / tape / replay machinery is unchanged.  Attr
    quad rows: loose quads [0, nl_pad), boxed faces [nl_pad, nl_pad + 6B),
    padding up to q_pad."""
    f = np.float32
    S = scene.sph_c0.shape[0]
    Q = scene.quad_q.shape[0]

    # ---- spheres (active rows only, big-first + Morton)
    c0_all = np.asarray(scene.sph_c0, np.float64)
    dc_all = np.asarray(scene.sph_dc, np.float64)
    rad_all = np.asarray(scene.sph_rad, np.float64)
    act_idx = np.nonzero(np.asarray(scene.sph_active))[0]
    sorder = act_idx[_sphere_order(c0_all[act_idx], dc_all[act_idx],
                                   rad_all[act_idx])]
    ns = len(sorder)
    s_pad = max(_pad_to(ns, CHUNK), CHUNK)
    sph = np.zeros((s_pad, SPH_COLS), np.float64)
    sph[:ns, 0:3] = c0_all[sorder]
    sph[:ns, 3:6] = dc_all[sorder]
    sph[:ns, 6] = np.asarray(scene.sph_t0, np.float64)[sorder]
    sph[:ns, 7] = np.asarray(scene.sph_inv_dt, np.float64)[sorder]
    sph[:ns, 8] = rad_all[sorder]
    # rad^2 squared in f32 host-side (bit-identical to rad*rad in f32);
    # padding rows carry -1: disc = b^2 - a(|oc|^2 + 1) < 0 always
    radf = rad_all[sorder].astype(f)
    sph[:ns, 10] = (radf * radf).astype(np.float64)
    sph[ns:, 10] = -1.0
    a, b = sph[:ns, 0:3], sph[:ns, 0:3] + sph[:ns, 3:6]
    r = sph[:ns, 8:9]
    cull_s = _chunk_boxes(np.minimum(a, b) - r, np.maximum(a, b) + r, s_pad)

    # ---- quads: boxes hoisted, loose quads Morton-ordered
    u_all = np.asarray(scene.quad_u, np.float64)
    v_all = np.asarray(scene.quad_v, np.float64)
    q_all = np.asarray(scene.quad_q, np.float64)
    qact_idx = np.nonzero(np.asarray(scene.quad_active))[0]
    boxes = _detect_boxes(qact_idx, q_all, u_all, v_all)
    boxed = (np.concatenate([g[0] for g in boxes]) if boxes
             else np.zeros(0, np.int64))
    loose = np.setdiff1d(qact_idx, boxed)
    if len(loose):
        qcent = q_all[loose] + 0.5 * (u_all[loose] + v_all[loose])
        loose = loose[np.argsort(_morton(qcent), kind="stable")]
    if boxes:
        bcent = np.stack([0.5 * (g[1] + g[2]) for g in boxes])
        boxes = [boxes[i] for i in np.argsort(_morton(bcent), kind="stable")]
    nl, nB = len(loose), len(boxes)
    nl_pad = _pad_to(nl, CHUNK)
    b_pad = _pad_to(nB, CHUNK)
    qorder = np.concatenate([loose] + [g[0] for g in boxes]).astype(np.int64)
    q_rows = np.concatenate(
        [np.arange(nl), nl_pad + np.arange(6 * nB)]).astype(np.int64)
    q_pad = max(_pad_to(nl_pad + 6 * nB, CHUNK), CHUNK) if meta.n_quads else 0

    u, v, qq = u_all[qorder], v_all[qorder], q_all[qorder]
    n = np.cross(u, v)
    n_len = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = n / np.where(n_len > 0, n_len, 1.0)
    nn = (n * n).sum(-1, keepdims=True)
    w_vec = n / np.where(nn > 0, nn, 1.0)
    vxw = np.cross(v, w_vec)
    wxu = np.cross(w_vec, u)
    quad = np.zeros((max(nl_pad, CHUNK), QUAD_COLS), np.float64)
    quad[:nl, 0:3] = n_unit[:nl]
    quad[:nl, 3] = (n_unit * qq).sum(-1)[:nl]
    quad[:nl, 4:7] = vxw[:nl]
    quad[:nl, 7] = (qq * vxw).sum(-1)[:nl]
    quad[:nl, 8:11] = wxu[:nl]
    quad[:nl, 11] = (qq * wxu).sum(-1)[:nl]
    corners = np.stack([qq, qq + u, qq + v, qq + u + v])[:, :nl]
    cull_q = _chunk_boxes(corners.min(0), corners.max(0), nl_pad)
    box = np.zeros((max(b_pad, CHUNK), BOX_COLS), np.float64)
    for g, (_ids, bmn, bmx) in enumerate(boxes):
        box[g, 0:3] = bmn
        box[g, 3:6] = bmx
        box[g, 6] = float(nl_pad + 6 * g)
        box[g, 7] = 1.0
    cull_b = _chunk_boxes(box[:nB, 0:3], box[:nB, 3:6], b_pad)

    # ---- winner attributes, one row per kernel geometry row + a zero row
    n_geo = s_pad + q_pad
    attr = np.zeros((n_geo + 1, ATTR_COLS), np.float64)
    attr[:s_pad, 0:9] = sph[:, 0:9]
    attr[:ns, 10:26] = _mat_cols(scene, np.asarray(scene.sph_mat)[sorder])
    attr[:ns, 21] = np.asarray(scene.sph_cos, np.float64)[sorder]
    attr[:ns, 22] = np.asarray(scene.sph_sin, np.float64)[sorder]
    if meta.n_quads:
        rows = s_pad + q_rows
        attr[rows, 0:3] = n_unit
        attr[s_pad:n_geo, 9] = 1.0
        attr[rows, 10:26] = _mat_cols(scene,
                                      np.asarray(scene.quad_mat)[qorder])
        attr[rows, 32:35] = vxw
        attr[rows, 35] = (qq * vxw).sum(-1)
        attr[rows, 36:39] = wxu
        attr[rows, 39] = (qq * wxu).sum(-1)

    M = max(meta.n_media, 1)
    med = np.zeros((M, 22), np.float64)
    med[:, 0] = scene.med_kind
    med[:, 1:4] = scene.med_center
    med[:, 4] = scene.med_radius
    med[:, 5:8] = scene.med_bmin
    med[:, 8:11] = scene.med_bmax
    med[:, 11] = scene.med_cos
    med[:, 12] = scene.med_sin
    med[:, 13] = scene.med_nid
    med[:, 16:19] = np.asarray(scene.med_off, np.float64)
    mtid = np.clip(np.asarray(scene.mat_tex)[np.asarray(scene.med_mat)], 0,
                   scene.tex_kind.shape[0] - 1)
    med[:, 19:22] = np.asarray(scene.tex_c0, np.float64)[mtid]

    # kernel row -> GLOBAL scene id (spheres [0,S), quads [S,S+Q), media
    # [S+Q, S+Q+M) — the id space of ops/replay.py tapes); padding -1
    remap = np.full(n_geo + M, -1, np.int32)
    remap[:ns] = sorder
    if meta.n_quads:
        remap[s_pad + q_rows] = S + qorder
    for m_i in range(meta.n_media):
        remap[n_geo + m_i] = S + Q + m_i

    perm, vec, img, img_dims = _texture_arrays(scene, meta)
    cull = np.concatenate([cull_s, cull_q, cull_b], axis=0)
    cull = np.concatenate([cull, np.zeros((cull.shape[0], 2))], axis=1)
    tabs = Mega2Tables(
        sph=jnp.asarray(sph.T, f), quad=jnp.asarray(quad.T, f),
        box=jnp.asarray(box.T, f), cull=jnp.asarray(cull.T, f),
        attr=jnp.asarray(attr.reshape(-1), f), perm=jnp.asarray(perm),
        vec=jnp.asarray(vec), img=jnp.asarray(img))
    layout = Mega2Layout(s_pad=s_pad, nl_pad=nl_pad if meta.n_quads else 0,
                         q_pad=q_pad, b_pad=b_pad if meta.n_quads else 0,
                         img_dims=img_dims)
    return tabs, layout, med, jnp.asarray(remap)


def _pcg4d(v0, v1, v2, v3):
    """pcg4d over uint32 arrays (core/rng.py, draw-exact)."""
    M = jnp.uint32(1664525)
    A = jnp.uint32(1013904223)
    v0 = v0 * M + A
    v1 = v1 * M + A
    v2 = v2 * M + A
    v3 = v3 * M + A
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


_INV24 = np.float32(1.0 / 16777216.0)
_TWO_PI = np.float32(2.0 * np.pi)
_PI = np.float32(np.pi)


def _u32(x):
    return lax.bitcast_convert_type(x, jnp.uint32)


def _unit(w):
    """Top 24 bits of a uint32 draw -> f32 in [0, 1), exactly."""
    return lax.bitcast_convert_type(w >> 8, jnp.int32).astype(jnp.float32) \
        * _INV24


def _scatter_dirs(kind, fuzz, ior, front, is_light, nx_, ny_, nz_,
                  dx, dy, dz, a, u1, u2, u3, u4):
    """Material scatter: new direction + the scattered flag, branchless over
    all five materials (Material.h / Metal.h:18-30 / Dielectric.h:18-55)."""
    # unit ball sample (core/samplers.py)
    zb = 1.0 - 2.0 * u1
    rxy = jnp.abs(1.0 - zb * zb) ** 0.5
    phi_b = _TWO_PI * u2
    sb = jnp.sin(phi_b)
    cb = jnp.cos(phi_b)
    rad_b = u3 ** np.float32(1.0 / 3.0)
    bx = rad_b * rxy * cb
    by = rad_b * rxy * sb
    bz = rad_b * zb

    inv_dlen = lax.rsqrt(a)
    udx, udy, udz = dx * inv_dlen, dy * inv_dlen, dz * inv_dlen

    # lambertian (Material.h:68-86 incl. NearZero fallback)
    lx, ly, lz = nx_ + bx, ny_ + by, nz_ + bz
    near0 = (jnp.abs(lx) < 1e-8) & (jnp.abs(ly) < 1e-8) & (jnp.abs(lz) < 1e-8)
    lx = jnp.where(near0, nx_, lx)
    ly = jnp.where(near0, ny_, ly)
    lz = jnp.where(near0, nz_, lz)

    # metal (Metal.h:18-30)
    ddn = udx * nx_ + udy * ny_ + udz * nz_
    rx = udx - 2.0 * ddn * nx_
    ry = udy - 2.0 * ddn * ny_
    rz = udz - 2.0 * ddn * nz_
    mx = rx + fuzz * bx
    my = ry + fuzz * by
    mz = rz + fuzz * bz
    metal_ok = (mx * nx_ + my * ny_ + mz * nz_) > 0.0

    # dielectric (Dielectric.h:18-55)
    ratio = jnp.where(front, 1.0 / ior, ior)
    cos_t = jnp.minimum(-(udx * nx_ + udy * ny_ + udz * nz_), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    om2 = one_m * one_m
    refl5 = r0 + (1.0 - r0) * om2 * om2 * one_m
    do_refl = cannot | (refl5 > u4)
    fx = ratio * (udx + cos_t * nx_)
    fy = ratio * (udy + cos_t * ny_)
    fz = ratio * (udz + cos_t * nz_)
    plen = jnp.abs(1.0 - (fx * fx + fy * fy + fz * fz))  # Vec3.h:138
    par = -(plen ** 0.5)
    gx = fx + par * nx_
    gy = fy + par * ny_
    gz = fz + par * nz_
    ddx = jnp.where(do_refl, rx, gx)
    ddy = jnp.where(do_refl, ry, gy)
    ddz = jnp.where(do_refl, rz, gz)

    # isotropic (Material.h:139-167): uniform unit direction
    ix_ = rxy * cb
    iy_ = rxy * sb
    iz_ = zb

    is_l = kind == float(MAT_LAMBERTIAN)
    is_m = kind == float(MAT_METAL)
    is_d = kind == float(MAT_DIELECTRIC)
    is_i = kind == float(MAT_ISOTROPIC)
    newx = jnp.where(is_l, lx, udx)
    newy = jnp.where(is_l, ly, udy)
    newz = jnp.where(is_l, lz, udz)
    newx = jnp.where(is_m, mx, newx)
    newy = jnp.where(is_m, my, newy)
    newz = jnp.where(is_m, mz, newz)
    newx = jnp.where(is_d, ddx, newx)
    newy = jnp.where(is_d, ddy, newy)
    newz = jnp.where(is_d, ddz, newz)
    newx = jnp.where(is_i, ix_, newx)
    newy = jnp.where(is_i, iy_, newy)
    newz = jnp.where(is_i, iz_, newz)

    scattered = (is_m & metal_ok) | (~is_m & ~is_light)
    return newx, newy, newz, scattered


def _perlin_noise(perm_ref, vec_ref, qx, qy, qz, table: int):
    """Lattice gradient noise (Perlin.h:38-60); every hashed permutation and
    gradient lookup is one indexed load from the flat tables."""
    base = 3 * 256 * table
    fx = jnp.floor(qx)
    fy = jnp.floor(qy)
    fz = jnp.floor(qz)
    ux, uy, uz = qx - fx, qy - fy, qz - fz
    i = fx.astype(jnp.int32)
    j = fy.astype(jnp.int32)
    k = fz.astype(jnp.int32)
    # Hermite cubic smoothing (Perlin.h:122-124)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    m = jnp.int32(255)
    pa = [perm_ref[base + ((i + d) & m)] for d in (0, 1)]
    pb = [perm_ref[base + 256 + ((j + d) & m)] for d in (0, 1)]
    pc = [perm_ref[base + 512 + ((k + d) & m)] for d in (0, 1)]
    accum = jnp.zeros_like(qx)
    for di in (0, 1):
        wu = sx if di else (1.0 - sx)
        for dj in (0, 1):
            wv = sy if dj else (1.0 - sy)
            for dk in (0, 1):
                ww = sz if dk else (1.0 - sz)
                h = base + (pa[di] ^ pb[dj] ^ pc[dk])
                dot = (vec_ref[h] * (ux - di)
                       + vec_ref[h + 256] * (uy - dj)
                       + vec_ref[h + 512] * (uz - dk))
                accum = accum + wu * wv * ww * dot
    return accum


def _perlin_turb(perm_ref, vec_ref, qx, qy, qz, table: int, depth: int = 7):
    """|sum_i 0.5^i noise(2^i p)| (Perlin.h:64-78), one loop iteration per
    octave (the scaling by 2 and 0.5 is exact)."""
    def octave(_, c):
        accum, weight, qx, qy, qz = c
        accum = accum + weight * _perlin_noise(perm_ref, vec_ref,
                                               qx, qy, qz, table)
        return accum, weight * 0.5, qx * 2.0, qy * 2.0, qz * 2.0

    accum = lax.fori_loop(0, depth, octave, (
        jnp.zeros_like(qx), jnp.ones_like(qx), qx, qy, qz))[0]
    return jnp.abs(accum)


class KernelSpec(NamedTuple):
    """Everything the kernel bakes in at compile time (a jit key)."""
    meta: SceneMeta
    layout: Mega2Layout
    med_key: tuple      # medium rows (M <= 3 in every reference scene)
    cam_key: tuple      # origin 3, lower_left 3, horizontal 3, vertical 3,
                        # u 3, v 3, lens_radius, time0, time1
    background: tuple
    seed: int
    max_bounces: int
    t_min: float
    cull: bool          # chunk culling (`CULL_MIN_PRIMS`)


def _make_kernel(spec: KernelSpec, *, mode: str, ext_rays: bool = False):
    """Build the kernel body.  ``mode="render"``: radiance sums of ``spp``
    samples per lane; ``mode="trace"``: one sample per lane, winner ids of
    every bounce (kernel-row id space)."""
    meta, lay = spec.meta, spec.layout
    f32 = np.float32
    bg = tuple(float(x) for x in spec.background)
    (c_ox, c_oy, c_oz, llx, lly, llz, hx, hy, hz, vx, vy, vz,
     ux, uy, uz, cvx, cvy, cvz, lens_r, tm0, tm1) = \
        [float(x) for x in spec.cam_key]
    med_rows = [[float(x) for x in row] for row in spec.med_key]
    seed = spec.seed
    t_min, max_bounces = spec.t_min, spec.max_bounces
    n_media = meta.n_media
    use_quads = meta.n_quads > 0
    has_checker = meta.has_checker
    has_moving = meta.has_moving
    # texture VALUES touch only radiance, never winners, normals or
    # scatter branching — the trace mode compiles them out
    has_noise = meta.has_noise and mode == "render"
    has_image = meta.has_image and mode == "render"
    n_noise = max(meta.n_noise, 1)
    s_pad, nl_pad, b_pad = lay.s_pad, lay.nl_pad, lay.b_pad
    n_geo = lay.n_geo
    n_s_ch, n_q_ch, n_b_ch = s_pad // CHUNK, nl_pad // CHUNK, b_pad // CHUNK
    cull = spec.cull
    L, C = LANES, PAIR_C

    def kernel(args_ref, pix_ref, samp_ref, rays_ref, sph_ref, quad_ref,
               box_ref, cull_ref, attr_ref, perm_ref, vec_ref, img_ref,
               *out_refs):
        # runtime scalars: one compiled kernel serves every frame size and
        # sample count.  Sample-axis shards render local samples [0, spp)
        # keyed on samp + s0, drawing the SAME streams as one device.
        s0, spp, width = args_ref[0], args_ref[1], args_ref[2]
        width_f = width.astype(jnp.float32)
        height_f = args_ref[3].astype(jnp.float32)
        lanes = pl.ds(pl.program_id(0) * L, L)
        pix = pix_ref[lanes]                       # global pixel id, -1 pad
        valid = pix >= 0
        pix_ctr = _u32(pix) ^ jnp.uint32(seed)
        safe = jnp.maximum(pix, 0)
        fvalid = valid.astype(jnp.float32)
        i_f = lax.rem(safe, width).astype(jnp.float32) * fvalid
        j_f = lax.div(safe, width).astype(jnp.float32) * fvalid
        iota_c = lax.broadcasted_iota(jnp.int32, (L, C), 1)

        def raygen(samp_u):
            """Camera ray for (pix, samp) — Camera.h:76-85 + kernel.cu:138-142,
            op for op as ops/raygen.py."""
            w0, w1, w2, w3 = _pcg4d(pix_ctr, samp_u,
                                    jnp.full_like(pix_ctr, rnglib.CAMERA_STREAM),
                                    jnp.zeros_like(pix_ctr))
            ju, jv, l1, l2 = _unit(w0), _unit(w1), _unit(w2), _unit(w3)
            t0_, _, _, _ = _pcg4d(pix_ctr, samp_u,
                                  jnp.full_like(pix_ctr, rnglib.CAMERA_STREAM + 1),
                                  jnp.zeros_like(pix_ctr))
            tu = _unit(t0_)
            s = (i_f + ju) / width_f
            t = (j_f + jv) / height_f
            rd_r = jnp.sqrt(l1)
            phi = _TWO_PI * l2
            rd0 = f32(lens_r) * (rd_r * jnp.cos(phi))
            rd1 = f32(lens_r) * (rd_r * jnp.sin(phi))
            offx = f32(ux) * rd0 + f32(cvx) * rd1
            offy = f32(uy) * rd0 + f32(cvy) * rd1
            offz = f32(uz) * rd0 + f32(cvz) * rd1
            ox = f32(c_ox) + offx
            oy = f32(c_oy) + offy
            oz = f32(c_oz) + offz
            dx = f32(llx) + s * f32(hx) + t * f32(vx) - f32(c_ox) - offx
            dy = f32(lly) + s * f32(hy) + t * f32(vy) - f32(c_oy) - offy
            dz = f32(llz) + s * f32(hz) + t * f32(vz) - f32(c_oz) - offz
            tmv = f32(tm0) + tu * (f32(tm1) - f32(tm0))
            return ox, oy, oz, dx, dy, dz, tmv

        def tile_min(key, cand, base, tb, win):
            """Masked min over a [L, C] tile; the lowest index wins ties,
            and a strictly smaller key replaces the running winner."""
            mn = jnp.min(key, axis=1)
            idx = jnp.min(jnp.where(key == mn[:, None], cand, 2 ** 30),
                          axis=1)
            better = mn < tb
            return jnp.where(better, mn, tb), jnp.where(better, base + idx,
                                                        win)

        def sph_tile(r0, ray, carry):
            """Sphere pair test in KEY space (key = t*a: a > 0 per ray, so
            key order is t order; the winner's t is recovered by ONE inv_a
            multiply after the walk) — the exact direct |o-c|^2 quadratic."""
            ox, oy, oz, dx, dy, dz, tmv, a, akey = ray
            tb, win = carry
            col = lambda k: sph_ref[k, pl.ds(r0, C)][None, :]   # [1, C]
            e = lambda v: v[:, None]                             # [L, 1]
            if has_moving:
                frac = (e(tmv) - col(6)) * col(7)
                cx = col(0) + frac * col(3)
                cy = col(1) + frac * col(4)
                cz = col(2) + frac * col(5)
            else:
                cx, cy, cz = col(0), col(1), col(2)
            ocx = e(ox) - cx
            ocy = e(oy) - cy
            ocz = e(oz) - cz
            b = ocx * e(dx) + ocy * e(dy) + ocz * e(dz)
            cc = ocx * ocx + ocy * ocy + ocz * ocz - col(10)
            disc = b * b - e(a) * cc
            # sqrt(negative) = NaN fails every comparison -> BIG below
            sq = jnp.sqrt(disc)
            k1 = -b - sq
            k2 = -b + sq
            key = jnp.where(k1 > e(akey), k1, k2)
            ok = (disc > 0.0) & (key > e(akey))
            key = jnp.where(ok, key, BIG)
            return tile_min(key, iota_c, r0, tb, win)

        def quad_tile(r0, ray, carry):
            ox, oy, oz, dx, dy, dz = ray[:6]
            tb, win = carry
            col = lambda k: quad_ref[k, pl.ds(r0, C)][None, :]
            e = lambda v: v[:, None]
            nx, ny, nz = col(0), col(1), col(2)
            denom = e(dx) * nx + e(dy) * ny + e(dz) * nz
            # padding rows are all-zero: denom = 0 fails den_ok
            den_ok = jnp.abs(denom) >= 1.0e-8
            t_c = (col(3) - (e(ox) * nx + e(oy) * ny + e(oz) * nz)) / \
                jnp.where(den_ok, denom, 1.0)
            px = e(ox) + t_c * e(dx)
            py = e(oy) + t_c * e(dy)
            pz = e(oz) + t_c * e(dz)
            alpha = px * col(4) + py * col(5) + pz * col(6) - col(7)
            beta = px * col(8) + py * col(9) + pz * col(10) - col(11)
            ok = (den_ok & (t_c >= t_min) & (alpha >= 0.0) & (alpha <= 1.0)
                  & (beta >= 0.0) & (beta <= 1.0))
            t_c = jnp.where(ok, t_c, BIG)
            return tile_min(t_c, iota_c, s_pad + r0, tb, win)

        def box_tile(r0, ray, carry):
            """One slab test per axis-aligned BOX replaces its six face
            tests.  Per-axis ts use the quad plane test's `(plane - o) / d`
            division, so the hit t is bit-identical; the winner is the hit
            FACE's quad row (face order: front,right,back,left,top,bottom
            — the scene compiler's `_box_quads`)."""
            ox, oy, oz, dx, dy, dz = ray[:6]
            tb, win = carry
            col = lambda k: box_ref[k, pl.ds(r0, C)][None, :]
            nears, fars, sides = [], [], []
            for ax, (o_a, d_a) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
                o_r, d_r = o_a[:, None], d_a[:, None]
                d_ok = jnp.abs(d_r) >= 1.0e-8
                dsafe = jnp.where(d_ok, d_r, 1.0)
                t1 = (col(ax) - o_r) / dsafe
                t2 = (col(3 + ax) - o_r) / dsafe
                # parallel ray: unconstrained inside the slab, a miss outside
                inside = (o_r >= col(ax)) & (o_r <= col(3 + ax))
                nears.append(jnp.where(d_ok, jnp.minimum(t1, t2),
                                       jnp.where(inside, -BIG, BIG)))
                fars.append(jnp.where(d_ok, jnp.maximum(t1, t2),
                                      jnp.where(inside, BIG, -BIG)))
                sides.append(d_r > 0.0)
            t_enter = jnp.maximum(jnp.maximum(nears[0], nears[1]), nears[2])
            t_exit = jnp.minimum(jnp.minimum(fars[0], fars[1]), fars[2])
            use_enter = t_enter >= t_min
            t_box = jnp.where(use_enter, t_enter, t_exit)
            ok = (t_enter <= t_exit) & (t_box >= t_min) & (col(7) > 0.5)
            # face offsets: entering crosses the min plane iff d > 0, exiting
            # the max plane iff d > 0; the first matching axis wins ties
            offs = ((3, 1), (5, 4), (2, 0))                 # (min, max)
            off_e = off_x = None
            for ax in range(3):
                mn_o, mx_o = offs[ax]
                oe = jnp.where(sides[ax], mn_o, mx_o)
                oxx = jnp.where(sides[ax], mx_o, mn_o)
                hit_e = nears[ax] == t_enter
                hit_x = fars[ax] == t_exit
                if off_e is None:
                    off_e = jnp.where(hit_e, oe, 0)
                    off_x = jnp.where(hit_x, oxx, 0)
                    seen_e, seen_x = hit_e, hit_x
                else:
                    off_e = jnp.where(~seen_e & hit_e, oe, off_e)
                    off_x = jnp.where(~seen_x & hit_x, oxx, off_x)
                    seen_e = seen_e | hit_e
                    seen_x = seen_x | hit_x
            off = jnp.where(use_enter, off_e, off_x)
            cand = col(6).astype(jnp.int32) + off           # local quad row
            t_c = jnp.where(ok, t_box, BIG)
            return tile_min(t_c, cand, s_pad, tb, win)

        def chunk_visible(c, ray, inv_d, active, tb, tscale=None):
            """Does ANY live lane's ray meet chunk c's AABB within its
            current (t_min, t_best) interval?  (AABB.h:68-98 slab test,
            BvhNode.h:150 — skipping on False cannot change the winner.)
            ``tscale``: t_best is in sphere KEY space (t*a)."""
            ox, oy, oz = ray[:3]
            ivx, ivy, ivz = inv_d
            cv = lambda k: cull_ref[k, c]
            tax = (cv(0) - ox) * ivx
            tbx = (cv(3) - ox) * ivx
            tay = (cv(1) - oy) * ivy
            tby = (cv(4) - oy) * ivy
            taz = (cv(2) - oz) * ivz
            tbz = (cv(5) - oz) * ivz
            near = jnp.maximum(jnp.maximum(jnp.minimum(tax, tbx),
                                           jnp.minimum(tay, tby)),
                               jnp.minimum(taz, tbz))
            far = jnp.minimum(jnp.minimum(jnp.maximum(tax, tbx),
                                          jnp.maximum(tay, tby)),
                              jnp.maximum(taz, tbz))
            near_k = near if tscale is None else near * tscale
            ok = (far >= jnp.maximum(near, t_min)) & (near_k < tb) & active
            return jnp.sum(ok.astype(jnp.int32)) > 0

        def walk(tile_fn, n_chunks, chunk0, ray, inv_d, active, carry,
                 tscale=None):
            per = CHUNK // C
            if not cull:
                return lax.fori_loop(
                    0, n_chunks * per,
                    lambda i, cr: tile_fn(i * C, ray, cr), carry)

            def chunk(c, carry):
                def run(carry):
                    return lax.fori_loop(
                        0, per,
                        lambda i, cr: tile_fn(c * CHUNK + i * C, ray, cr),
                        carry)

                vis = chunk_visible(chunk0 + c, ray, inv_d, active, carry[0],
                                    tscale)
                return lax.cond(vis, run, lambda cr: cr, carry)

            return lax.fori_loop(0, n_chunks, chunk, carry)

        def gather_attr(aidx, k):
            return attr_ref[aidx * ATTR_COLS + k]

        def bounce_core(ox, oy, oz, dx, dy, dz, tmv, thr_r, thr_g, thr_b,
                        acc_r, acc_g, acc_b, active, bu, samp_u):
            """One full bounce (hit -> record -> texture -> shade ->
            accumulate; kernel.cu:71-95).  Returns the advanced state plus
            the winner id (kernel row, n_geo + m for medium m, -1 miss)."""
            a = dx * dx + dy * dy + dz * dz
            inv_a = 1.0 / a
            akey = np.float32(t_min) * a       # t_min in sphere KEY space
            ray = (ox, oy, oz, dx, dy, dz, tmv, a, akey)
            inv_d = None
            if cull:
                # sanitized reciprocal directions for the chunk slab tests
                tiny = np.float32(1.0e-30)
                san = lambda v: jnp.where(v >= 0.0, jnp.maximum(v, tiny),
                                          jnp.minimum(v, -tiny))
                inv_d = (1.0 / san(dx), 1.0 / san(dy), 1.0 / san(dz))
            carry = (jnp.full((L,), BIG, jnp.float32),
                     jnp.full((L,), -1, jnp.int32))
            carry = walk(sph_tile, n_s_ch, 0, ray, inv_d, active, carry,
                         tscale=a)
            t_best, win = carry
            t_best = jnp.where(t_best < BIG * 0.5, t_best * inv_a, BIG)
            carry = (t_best, win)
            if n_q_ch:
                carry = walk(quad_tile, n_q_ch, n_s_ch, ray, inv_d, active,
                             carry)
            if n_b_ch:
                carry = walk(box_tile, n_b_ch, n_s_ch + n_q_ch, ray, inv_d,
                             active, carry)
            t_best, win = carry

            # winner attributes: one indexed load per column; misses read
            # the table's trailing zero row
            aidx = jnp.where(win >= 0, win, n_geo)
            cache = {}

            def arow(k):
                if k not in cache:
                    cache[k] = gather_attr(aidx, k)
                return cache[k]

            if has_moving:
                frac_w = (tmv - arow(6)) * arow(7)
                wcx = arow(0) + frac_w * arow(3)
                wcy = arow(1) + frac_w * arow(4)
                wcz = arow(2) + frac_w * arow(5)
            else:
                wcx, wcy, wcz = arow(0), arow(1), arow(2)
            wrad = arow(8)
            is_quad = arow(9) > 0.5 if use_quads else jnp.zeros_like(valid)
            mat = [arow(10 + m) for m in range(11)]

            # ---- stochastic media (ConstantMedium.h)
            is_med = jnp.zeros_like(valid)
            med_alb = [jnp.zeros_like(ox) for _ in range(3)]
            for m in range(n_media):
                r = med_rows[m]
                w0, _, _, _ = _pcg4d(
                    pix_ctr, samp_u, jnp.uint32(rnglib.MEDIUM_STREAM) | bu,
                    jnp.full_like(pix_ctr, m))
                u_m = _unit(w0) + _INV24                      # (0,1]
                if int(r[0]) == MED_BOX:
                    c2, s2 = r[11], r[12]
                    pox, poy, poz = ox - r[16], oy - r[17], oz - r[18]
                    o1 = c2 * pox - s2 * poz
                    o2 = poy
                    o3 = s2 * pox + c2 * poz
                    e1 = c2 * dx - s2 * dz
                    e2 = dy
                    e3 = s2 * dx + c2 * dz
                    iv1, iv2, iv3 = 1.0 / e1, 1.0 / e2, 1.0 / e3
                    ta1, tb1 = (r[5] - o1) * iv1, (r[8] - o1) * iv1
                    ta2, tb2 = (r[6] - o2) * iv2, (r[9] - o2) * iv2
                    ta3, tb3 = (r[7] - o3) * iv3, (r[10] - o3) * iv3
                    t0 = jnp.maximum(jnp.maximum(
                        jnp.minimum(ta1, tb1), jnp.minimum(ta2, tb2)),
                        jnp.minimum(ta3, tb3))
                    t1 = jnp.minimum(jnp.minimum(
                        jnp.maximum(ta1, tb1), jnp.maximum(ta2, tb2)),
                        jnp.maximum(ta3, tb3))
                    m_valid = t1 > t0
                else:
                    ocx, ocy, ocz = ox - r[1], oy - r[2], oz - r[3]
                    b = ocx * dx + ocy * dy + ocz * dz
                    cc = ocx * ocx + ocy * ocy + ocz * ocz - r[4] * r[4]
                    disc = b * b - a * cc
                    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
                    t0 = (-b - sq) * inv_a
                    t1 = (-b + sq) * inv_a
                    m_valid = disc > 0.0
                m_valid = m_valid & (t1 > t0 + 1.0e-4)
                t0c = jnp.maximum(jnp.maximum(t0, t_min), 0.0)
                m_valid = m_valid & (t0c < t1)
                ray_len = jnp.sqrt(a)
                dist_in = (t1 - t0c) * ray_len
                hit_d = r[13] * jnp.log(u_m)
                m_valid = m_valid & (hit_d <= dist_in)
                t_m = t0c + hit_d / ray_len
                mwin = m_valid & (t_m < t_best)
                t_best = jnp.where(mwin, t_m, t_best)
                is_med = is_med | mwin
                is_quad = is_quad & ~mwin
                win = jnp.where(mwin, n_geo + m, win)
                for k in range(3):
                    med_alb[k] = jnp.where(mwin, r[19 + k], med_alb[k])
                mat[0] = jnp.where(mwin, float(MAT_ISOTROPIC), mat[0])

            hit = t_best < BIG * 0.5

            # ---- miss -> background (kernel.cu:74-79)
            miss = active & ~hit
            acc_r = acc_r + jnp.where(miss, thr_r * bg[0], 0.0)
            acc_g = acc_g + jnp.where(miss, thr_g * bg[1], 0.0)
            acc_b = acc_b + jnp.where(miss, thr_b * bg[2], 0.0)
            alive = active & hit

            # ---- hit record (Hittable.h:11-31 SetFaceNormal semantics)
            px = ox + t_best * dx
            py = oy + t_best * dy
            pz = oz + t_best * dz
            inv_rad = 1.0 / jnp.where(wrad != 0.0, wrad, 1.0)
            nsx = (px - wcx) * inv_rad
            nsy = (py - wcy) * inv_rad
            nsz = (pz - wcz) * inv_rad
            n_outx = jnp.where(is_quad, wcx, nsx)
            n_outy = jnp.where(is_quad, wcy, nsy)
            n_outz = jnp.where(is_quad, wcz, nsz)
            if n_media > 0:
                n_outx = jnp.where(is_med, 1.0, n_outx)
                n_outy = jnp.where(is_med, 0.0, n_outy)
                n_outz = jnp.where(is_med, 0.0, n_outz)
            d_dot_n = dx * n_outx + dy * n_outy + dz * n_outz
            front = (d_dot_n < 0.0) | is_med
            flip = jnp.where(front, 1.0, -1.0)
            nx_ = n_outx * flip
            ny_ = n_outy * flip
            nz_ = n_outz * flip

            # ---- texture value (solid | checker; Texture.h:48-87)
            tc0r, tc0g, tc0b = mat[4], mat[5], mat[6]
            texr, texg, texb = tc0r, tc0g, tc0b
            if has_checker:
                inv_s = mat[10]
                cellx = jnp.floor(inv_s * px).astype(jnp.int32)
                celly = jnp.floor(inv_s * py).astype(jnp.int32)
                cellz = jnp.floor(inv_s * pz).astype(jnp.int32)
                even = ((cellx + celly + cellz) & 1) == 0
                is_ck = mat[3] == float(TEX_CHECKER)
                pickc = lambda c0, c1: jnp.where(
                    is_ck, jnp.where(even, c0, c1), c0)
                texr = pickc(tc0r, mat[7])
                texg = pickc(tc0g, mat[8])
                texb = pickc(tc0b, mat[9])
            if has_noise:
                # marble 0.5*(1+sin(scale*z + 10*turb)) (Texture.h:163-164),
                # skipped by blocks with no live noise winner; one
                # turbulence per noise table, selected by attr col 25
                is_nz = mat[3] == float(TEX_NOISE)
                run_nz = jnp.sum((alive & is_nz).astype(jnp.int32)) > 0

                def noise_tex(_):
                    turb = _perlin_turb(perm_ref, vec_ref, px, py, pz, 0)
                    for t in range(1, n_noise):
                        turb_t = _perlin_turb(perm_ref, vec_ref, px, py, pz, t)
                        turb = jnp.where(arow(25) == float(t), turb_t, turb)
                    return 0.5 * (1.0 + jnp.sin(arow(23) * pz + 10.0 * turb))

                marble = lax.cond(run_nz, noise_tex,
                                  lambda _: jnp.zeros_like(px), 0)
                texr = jnp.where(is_nz, marble, texr)
                texg = jnp.where(is_nz, marble, texg)
                texb = jnp.where(is_nz, marble, texb)
            if has_image:
                is_im = mat[3] == float(TEX_IMAGE)
                run_im = jnp.sum((alive & is_im).astype(jnp.int32)) > 0

                def image_tex(_):
                    # sphere UV from the object-space outward normal
                    # (GetSphereUV Sphere.h:74-81; instanced frame cols 21/22)
                    cth = arow(21)
                    sth = arow(22)
                    ox_n = cth * nsx - sth * nsz
                    oz_n = sth * nsx + cth * nsz
                    ny_c = jnp.clip(-nsy, -1.0, 1.0)
                    theta = jnp.arccos(ny_c)
                    phi = jnp.arctan2(-oz_n, ox_n) + _PI
                    u_s = phi * np.float32(0.5 / np.pi)
                    v_s = theta * np.float32(1.0 / np.pi)
                    if use_quads:
                        # quad UV = interior coords (alpha,beta) from the
                        # cached plane frame (Quad.h:89-99), attr 32:40
                        u_q = (px * arow(32) + py * arow(33)
                               + pz * arow(34) - arow(35))
                        v_q = (px * arow(36) + py * arow(37)
                               + pz * arow(38) - arow(39))
                        u_s = jnp.where(is_quad, u_q, u_s)
                        v_s = jnp.where(is_quad, v_q, v_s)
                    # nearest texel, u clamped / v flipped (Texture.h:117-127)
                    uu = jnp.clip(u_s, 0.0, 1.0)
                    vv = 1.0 - jnp.clip(v_s, 0.0, 1.0)
                    tr = tg = tb = jnp.zeros_like(px)
                    m255 = jnp.int32(255)
                    inv255 = np.float32(1.0 / 255.0)
                    for i, (iw, ih, off) in enumerate(lay.img_dims):
                        ix = jnp.clip((uu * iw).astype(jnp.int32), 0, iw - 1)
                        iy = jnp.clip((vv * ih).astype(jnp.int32), 0, ih - 1)
                        packed = img_ref[off + iy * iw + ix]
                        ci = [((packed >> sh) & m255).astype(jnp.float32)
                              * inv255 for sh in (16, 8, 0)]
                        sel = arow(24) == float(i)
                        tr = jnp.where(sel, ci[0], tr)
                        tg = jnp.where(sel, ci[1], tg)
                        tb = jnp.where(sel, ci[2], tb)
                    # missing image -> debug cyan (Texture.h:112-114)
                    absent = arow(24) < 0.0
                    tr = jnp.where(absent, 0.0, tr)
                    tg = jnp.where(absent, 1.0, tg)
                    tb = jnp.where(absent, 1.0, tb)
                    return tr, tg, tb

                z = jnp.zeros_like(px)
                imr, img_, imb = lax.cond(run_im, image_tex,
                                          lambda _: (z, z, z), 0)
                texr = jnp.where(is_im, imr, texr)
                texg = jnp.where(is_im, img_, texg)
                texb = jnp.where(is_im, imb, texb)
            if n_media > 0:
                texr = jnp.where(is_med, med_alb[0], texr)
                texg = jnp.where(is_med, med_alb[1], texg)
                texb = jnp.where(is_med, med_alb[2], texb)

            kind, fuzz, ior = mat[0], mat[1], mat[2]
            is_light = kind == float(MAT_DIFFUSE_LIGHT)

            # emission (Material.h:114-117; live lanes only)
            acc_r = acc_r + jnp.where(alive & is_light, thr_r * texr, 0.0)
            acc_g = acc_g + jnp.where(alive & is_light, thr_g * texg, 0.0)
            acc_b = acc_b + jnp.where(alive & is_light, thr_b * texb, 0.0)

            # ---- scatter RNG (SCATTER_STREAM | bounce)
            w0, w1, w2, w3 = _pcg4d(
                pix_ctr, samp_u, jnp.uint32(rnglib.SCATTER_STREAM) | bu,
                jnp.zeros_like(pix_ctr))
            u1, u2, u3, u4 = _unit(w0), _unit(w1), _unit(w2), _unit(w3)
            newx, newy, newz, scattered = _scatter_dirs(
                kind, fuzz, ior, front, is_light, nx_, ny_, nz_,
                dx, dy, dz, a, u1, u2, u3, u4)
            is_d = kind == float(MAT_DIELECTRIC)
            att_r = jnp.where(is_d, 1.0, texr)
            att_g = jnp.where(is_d, 1.0, texg)
            att_b = jnp.where(is_d, 1.0, texb)
            alive = alive & scattered
            thr_r = jnp.where(alive, thr_r * att_r, thr_r)
            thr_g = jnp.where(alive, thr_g * att_g, thr_g)
            thr_b = jnp.where(alive, thr_b * att_b, thr_b)
            ox = jnp.where(alive, px, ox)
            oy = jnp.where(alive, py, oy)
            oz = jnp.where(alive, pz, oz)
            dx = jnp.where(alive, newx, dx)
            dy = jnp.where(alive, newy, dy)
            dz = jnp.where(alive, newz, dz)
            win = jnp.where(active, win, -1)
            return (ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b,
                    acc_r, acc_g, acc_b, alive, win)

        zf = jnp.zeros((L,), jnp.float32)
        if mode == "trace":
            # one sample per lane, fixed depth, per-bounce winner rows
            (win_ref,) = out_refs
            K = max_bounces
            neg1 = jnp.full((L,), -1, jnp.int32)
            for k in range(K):
                win_ref[k, lanes] = neg1
            samp_u = _u32(samp_ref[lanes])
            if ext_rays:
                # rays made in-graph by ops/raygen.generate_rays: keeps a
                # (possibly traced) camera out of the kernel's constants
                ox, oy, oz, dx, dy, dz, tmv = [rays_ref[r, lanes]
                                               for r in range(7)]
            else:
                ox, oy, oz, dx, dy, dz, tmv = raygen(samp_u)

            def cond_t(c):
                return (c[0] < K) & (jnp.sum(c[-1]) > 0)

            def body_t(c):
                (b, ox, oy, oz, dx, dy, dz,
                 thr_r, thr_g, thr_b, acc_r, acc_g, acc_b, act_i) = c
                bu = _u32(jnp.full((L,), b, jnp.int32))
                (ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b,
                 acc_r, acc_g, acc_b, alive, win) = bounce_core(
                    ox, oy, oz, dx, dy, dz, tmv, thr_r, thr_g, thr_b,
                    acc_r, acc_g, acc_b, act_i > 0, bu, samp_u)
                win_ref[b, lanes] = win
                return (b + 1, ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b,
                        acc_r, acc_g, acc_b, alive.astype(jnp.int32))

            lax.while_loop(cond_t, body_t, (
                jnp.int32(0), ox, oy, oz, dx, dy, dz, zf + 1.0, zf + 1.0,
                zf + 1.0, zf, zf, zf, valid.astype(jnp.int32)))
            return

        out_ref, segs_ref = out_refs

        def step(carry):
            (ox, oy, oz, dx, dy, dz, tmv, thr_r, thr_g, thr_b,
             acc_r, acc_g, acc_b, lane_r, lane_g, lane_b,
             samp, bounce, active_i, segs) = carry
            active = active_i > 0
            segs = segs + active_i
            (ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b,
             acc_r, acc_g, acc_b, alive, _win) = bounce_core(
                ox, oy, oz, dx, dy, dz, tmv, thr_r, thr_g, thr_b,
                acc_r, acc_g, acc_b, active, _u32(bounce), _u32(samp + s0))
            bounce2 = bounce + 1
            alive = alive & (bounce2 < max_bounces)

            # ---- sample-sequential refill: a terminated path banks its
            # radiance and the lane starts its pixel's next sample
            term = active & ~alive
            lane_r = lane_r + jnp.where(term, acc_r, 0.0)
            lane_g = lane_g + jnp.where(term, acc_g, 0.0)
            lane_b = lane_b + jnp.where(term, acc_b, 0.0)
            samp2 = samp + term.astype(jnp.int32)
            need_new = term & (samp2 < spp)
            nox, noy, noz, ndx, ndy, ndz, ntm = raygen(_u32(samp2 + s0))
            sel = lambda n, o: jnp.where(need_new, n, o)
            ox, oy, oz = sel(nox, ox), sel(noy, oy), sel(noz, oz)
            dx, dy, dz = sel(ndx, dx), sel(ndy, dy), sel(ndz, dz)
            tmv = sel(ntm, tmv)
            thr_r, thr_g, thr_b = sel(1.0, thr_r), sel(1.0, thr_g), \
                sel(1.0, thr_b)
            acc_r, acc_g, acc_b = sel(0.0, acc_r), sel(0.0, acc_g), \
                sel(0.0, acc_b)
            bounce2 = jnp.where(need_new, 0, bounce2)
            active2 = ((alive | need_new) & valid).astype(jnp.int32)
            return (ox, oy, oz, dx, dy, dz, tmv, thr_r, thr_g, thr_b,
                    acc_r, acc_g, acc_b, lane_r, lane_g, lane_b,
                    samp2, bounce2, active2, segs)

        zi = jnp.zeros((L,), jnp.int32)
        ray0 = raygen(_u32(zi + s0))
        carry = (*ray0, zf + 1.0, zf + 1.0, zf + 1.0, zf, zf, zf, zf, zf, zf,
                 zi, zi, valid.astype(jnp.int32), zi)
        carry = lax.while_loop(lambda c: jnp.sum(c[18]) > 0, step, carry)
        out_ref[0, lanes] = carry[13]
        out_ref[1, lanes] = carry[14]
        out_ref[2, lanes] = carry[15]
        segs_ref[lanes] = carry[19]

    return kernel


def _call(spec: KernelSpec, tabs: Mega2Tables, pix, *, mode: str, spp,
          samp0, width: int, height: int, samp=None, rays=None,
          interpret: bool):
    """Run the kernel over lanes ``pix`` [N] (N a LANES multiple)."""
    N = pix.shape[0]
    assert N % LANES == 0, N
    kernel = _make_kernel(spec, mode=mode, ext_rays=rays is not None)
    if mode == "trace":
        out_shape = jax.ShapeDtypeStruct((spec.max_bounces, N), jnp.int32)
    else:
        out_shape = (jax.ShapeDtypeStruct((3, N), jnp.float32),
                     jax.ShapeDtypeStruct((N,), jnp.int32))
    samp = jnp.zeros((N,), jnp.int32) if samp is None else samp
    rays = jnp.zeros((7, LANES), jnp.float32) if rays is None else rays
    return pl.pallas_call(
        kernel,
        grid=(N // LANES,),
        out_shape=out_shape,
        backend=PALLAS_BACKEND,
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name=f"mega2_{mode}",
    )(jnp.stack([jnp.asarray(v, jnp.int32) for v in
                 (samp0, spp, width, height)]), pix, samp, rays, *tabs)


def render_lanes(spec: KernelSpec, tabs: Mega2Tables, pix, *, spp,
                 width: int, height: int, samp0=0, interpret: bool):
    """Radiance SUMS [3, N] over samples [samp0, samp0 + spp) and path
    segments [N] for the lanes ``pix`` [N] (-1 = padding) of a width x
    height frame — unjitted, for composition under a jit or a shard_map."""
    return _call(spec, tabs, pix, mode="render", spp=spp, samp0=samp0,
                 width=width, height=height, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("spec", "width", "height",
                                             "gamma", "out_u8", "interpret"))
def render_mega2_frame(tabs: Mega2Tables, spp, *, spec: KernelSpec,
                       width: int, height: int, gamma: bool, out_u8: bool,
                       interpret: bool):
    """Whole frame in ONE jitted call: the kernel, then the average / gamma
    / quantize epilogue (kernel.cu:147-152, 709-718) -> flat [npix * 3].
    ``spp`` is a runtime value: one executable serves every sample count."""
    from .wavefront import _finalize

    npix = width * height
    N = _pad_to(npix, LANES)
    ids = lax.iota(jnp.int32, N)
    pix = jnp.where(ids < npix, ids, -1)
    sums, _ = render_lanes(spec, tabs, pix, spp=spp, width=width,
                           height=height, interpret=interpret)
    return _finalize(sums[:, :npix].T, spp, gamma, out_u8).reshape(-1)


def _trace_lanes(spec: KernelSpec, tabs: Mega2Tables, remap, pix, samp, *,
                 width: int, height: int, interpret: bool,
                 remap_ids: bool = True, rays=None):
    """Winner tape [max_bounces, N] for lanes (pix [N], samp [N]) of a
    width x height frame — GLOBAL scene ids when ``remap_ids``, kernel
    rows otherwise."""
    win = _call(spec, tabs, pix, mode="trace", spp=1, samp0=0, width=width,
                height=height, samp=samp, rays=rays, interpret=interpret)
    if not remap_ids:
        return win
    return jnp.where(win >= 0, remap[jnp.clip(win, 0)], -1)


def _tapes_trace(spec: KernelSpec, tabs: Mega2Tables, remap, pix_ids, *,
                 width, height, n_samples, samp0, interpret, remap_ids=True,
                 camera=None):
    """All-samples winner tape -> [n_samples, max_bounces, B] for the pixel
    ids ``pix_ids`` [B] (traced ok; lanes gathered in-graph), samples
    ``samp0 + [0, n_samples)``.  Composable under a jit or a shard_map.

    ``camera`` switches primary-ray generation: ``None`` runs the in-kernel
    raygen (camera baked from ``spec.cam_key``); a CameraParams — possibly
    holding tracers, e.g. the trainable camera under the train step's jit —
    generates rays in-graph with `ops/raygen.generate_rays` and feeds them
    to the kernel, so tape and replay share the very same rays."""
    from .raygen import generate_rays

    pix_ids = jnp.asarray(pix_ids, jnp.int32)
    B = pix_ids.shape[0]
    Lt = B * n_samples
    N = _pad_to(Lt, LANES)
    lane = lax.iota(jnp.int32, N)
    live = lane < Lt
    pid = jnp.take(pix_ids, lane % B)
    pix = jnp.where(live, pid, -1)
    samp = jnp.where(live, samp0 + lane // B, 0)
    rays = None
    if camera is not None:
        o, d, tmv, _ = generate_rays(camera, jnp.where(live, pid, 0),
                                     samp.astype(jnp.uint32), width, height,
                                     spec.seed)
        rays = jnp.concatenate([
            o.T.astype(jnp.float32), d.T.astype(jnp.float32),
            jnp.asarray(tmv, jnp.float32)[None, :]], axis=0)   # [7, N]
        # padding lanes keep a unit-z direction (a = 0 is degenerate)
        pad_ray = jnp.zeros((7, 1), jnp.float32).at[5, 0].set(1.0)
        rays = jnp.where(live[None, :], rays, pad_ray)
    tape = _trace_lanes(spec, tabs, remap, pix, samp, width=width,
                        height=height, interpret=interpret,
                        remap_ids=remap_ids, rays=rays)
    K = spec.max_bounces
    return tape[:, :Lt].reshape(K, n_samples, B).transpose(1, 0, 2)


@functools.partial(jax.jit, static_argnames=("spec", "width", "height",
                                             "n_samples", "interpret",
                                             "remap_ids"))
def _tapes_jit(tabs, remap, pix_ids, camera=None, *, spec, width, height,
               n_samples, interpret, remap_ids=True):
    return _tapes_trace(spec, tabs, remap, pix_ids, width=width,
                        height=height, n_samples=n_samples, samp0=0,
                        interpret=interpret, remap_ids=remap_ids,
                        camera=camera)


def _cam_tuple(camera) -> tuple:
    c = camera
    vals = []
    for name in ("origin", "lower_left", "horizontal", "vertical", "u", "v"):
        vals.extend(float(x) for x in np.asarray(getattr(c, name)))
    vals.append(float(np.asarray(c.lens_radius)))
    vals.append(float(np.asarray(c.time0)))
    vals.append(float(np.asarray(c.time1)))
    return tuple(vals)


_TABLE_CACHE: dict = {}


def mega2_tables(scene: SceneArrays, meta: SceneMeta):
    """Cached `pack_mega2_tables`, keyed on EVERY scene leaf
    (`scene.compiler.cached_pack`): geometry-only keys would serve stale
    material/texture tables during training."""
    from ..scene.compiler import cached_pack

    return cached_pack(_TABLE_CACHE, scene, "mega2",
                       lambda: pack_mega2_tables(scene, meta))


def kernel_spec(scene: SceneArrays, meta: SceneMeta, layout: Mega2Layout,
                med, *, seed: int, max_bounces: int, t_min: float,
                cull: bool | None = None, camera: bool = True) -> KernelSpec:
    """The static half of a kernel call.  ``cull=None`` decides chunk
    culling from the world size; ``camera=False`` leaves the camera and
    background out of the key (tapes from external rays)."""
    if cull is None:
        cull = layout.pair_rows > CULL_MIN_PRIMS
    return KernelSpec(
        meta=meta, layout=layout,
        med_key=tuple(tuple(float(x) for x in row) for row in med),
        cam_key=_cam_tuple(scene.camera) if camera else (0.0,) * 21,
        background=(tuple(float(x) for x in np.asarray(
            scene.camera.background)) if camera else (0.0, 0.0, 0.0)),
        seed=seed, max_bounces=max_bounces, t_min=float(t_min),
        cull=bool(cull))


def mega2_tapes(scene: SceneArrays, meta: SceneMeta, pix_ids, n_samples, *,
                width: int, height: int, max_bounces: int, t_min: float,
                seed: int, id_space: str = "global"):
    """Winner tapes [n_samples, max_bounces, B] for samples 0..n_samples-1
    of the pixel ids [B] in one device dispatch.  ``id_space="global"``
    remaps winners to the `ops/replay.py` scene id space; ``"kernel"``
    returns kernel rows (see `mega2_kernel_id_space`)."""
    tabs, layout, med, remap = mega2_tables(scene, meta)
    spec = kernel_spec(scene, meta, layout, med, seed=seed,
                       max_bounces=max_bounces, t_min=t_min)
    return _tapes_jit(tabs, remap, jnp.asarray(np.asarray(pix_ids, np.int32)),
                      spec=spec, width=width, height=height,
                      n_samples=int(n_samples),
                      interpret=pallas_interpret(),
                      remap_ids=(id_space == "global"))


def mega2_tape(scene: SceneArrays, meta: SceneMeta, pix_ids, samp, *,
               width: int, height: int, max_bounces: int, t_min: float,
               seed: int):
    """Winner tape [max_bounces, B] (GLOBAL ids) for sample ``samp`` of the
    pixel ids [B]."""
    tabs, layout, med, remap = mega2_tables(scene, meta)
    spec = kernel_spec(scene, meta, layout, med, seed=seed,
                       max_bounces=max_bounces, t_min=t_min)
    pix_ids = np.asarray(pix_ids, np.int32)
    B = pix_ids.shape[0]
    N = _pad_to(B, LANES)
    pix = np.full(N, -1, np.int32)
    pix[:B] = pix_ids
    samp_arr = np.full(N, int(samp), np.int32)
    tape = jax.jit(_trace_lanes, static_argnames=(
        "spec", "width", "height", "interpret"))(
        spec, tabs, remap, jnp.asarray(pix), jnp.asarray(samp_arr),
        width=width, height=height, interpret=pallas_interpret())
    return tape[:, :B]


def mega2_kernel_id_space(scene: SceneArrays, meta: SceneMeta):
    """(remap, s_pad) describing the trace kernel's winner-id space:
    ``remap[k]`` is the GLOBAL scene id of kernel geometry row k (-1 for
    padding rows, which never win); rows [0, s_pad) are spheres, then quads,
    then the M media (winner id n_geo + m maps to global id S + Q + m)."""
    _tabs, layout, _med, remap = mega2_tables(scene, meta)
    return remap, layout.s_pad


def render_mega2(scene: SceneArrays, meta: SceneMeta, cfg: RenderConfig, *,
                 gamma: bool = True, out_u8: bool = False,
                 device_out: bool = False, cull: bool | None = None):
    """Full-frame megakernel render -> numpy [H,W,3] (top row first).

    ``device_out`` returns the flat on-device framebuffer instead (finish
    with `mega2_host_image`): the reference stops its clock before the
    framebuffer readback (kernel.cu:675-693), and so can a benchmark."""
    tabs, layout, med, _remap = mega2_tables(scene, meta)
    W, H = cfg.width, cfg.height
    spec = kernel_spec(scene, meta, layout, med, seed=cfg.seed,
                       max_bounces=cfg.max_bounces, t_min=cfg.t_min,
                       cull=cull)
    fb = render_mega2_frame(tabs, jnp.int32(cfg.samples_per_pixel),
                            spec=spec, width=W, height=H, gamma=gamma,
                            out_u8=out_u8, interpret=pallas_interpret())
    if device_out:
        return fb
    return mega2_host_image(fb, H, W)


def mega2_host_image(fb, H: int, W: int) -> np.ndarray:
    """Flat device framebuffer -> numpy [H,W,3], top row first."""
    return np.asarray(fb).reshape(H, W, 3)[::-1]
