"""The XLA taped replay (`ops/replay.py`) over the scene-feature matrix.

Contract: with the winners fixed by `generate_tape`, the replay's primal
equals the search path's radiance (same RNG draws, same shade tail) up to
f32 rounding of the winner's re-intersection, and its gradients are the
pathwise derivatives — checked against central finite differences of the
replay itself, per feature: textured and media primal, medium albedo and
geometry gradients, ray/time cotangents, several images and quad UVs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracinginoneweekendincuda_tpu.core.camera import Camera
from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops import replay as rp
from raytracinginoneweekendincuda_tpu.ops.raygen import generate_rays
from raytracinginoneweekendincuda_tpu.scene.api import (
    Box, ConstantMedium, DiffuseLight, ImageTexture, Lambertian,
    NoiseTexture, Quad, SceneDesc, Sphere,
)
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene

W, H, K = 16, 12, 2


def _setup_desc(desc, k=K):
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, scene)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    o, d, t, pc = generate_rays(scene.camera, pix, jnp.uint32(0), W, H, 1984)
    tape, acc = rp.generate_tape(scene, meta, o, d, t, pc, jnp.uint32(0),
                                 max_bounces=k, t_min=1e-3)
    return scene, meta, tape, acc, o, d, t, pc


def _bytes255(img):
    return np.round(img * 255.0) / 255.0


def _ramp_img(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / (w - 1), y / (h - 1), (x + y) / (w + h - 2)], -1)
    return _bytes255(np.ascontiguousarray(img))


def _multi_image():
    """Two images of different sizes on spheres plus an image on a quad."""
    desc = SceneDesc()
    desc.add(
        Sphere((-2.2, 0, 0), 1.0, Lambertian(ImageTexture(_ramp_img(12, 20)))),
        Sphere((2.2, 0, 0), 1.0, Lambertian(ImageTexture(_ramp_img(9, 14)))),
        Quad((-2, -2, -2), (4, 0, 0), (0, 4, 0),
             Lambertian(ImageTexture(_ramp_img(12, 20)))),
    )
    desc.camera = Camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vfov=40.0,
                         background=(0.70, 0.80, 1.00))
    return desc


def _multi_noise():
    """Two Perlin tables (different seeds)."""
    desc = SceneDesc()
    desc.add(
        Sphere((0, -1000, 0), 1000.0,
               Lambertian(NoiseTexture(4.0, table_seed=0))),
        Sphere((0, 2, 0), 2.0, Lambertian(NoiseTexture(2.0, table_seed=7))),
    )
    desc.camera = Camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=20.0,
                         background=(0.70, 0.80, 1.00))
    return desc


def _media_probe():
    """Sphere + box constant media in front of a large light: at 2 bounces
    scatter-in-medium -> hit-light paths exist for both media."""
    desc = SceneDesc()
    desc.add(
        ConstantMedium(Sphere((-0.6, 0.0, -1.5), 0.5, Lambertian((1, 1, 1))),
                       0.7, (0.8, 0.4, 0.2)),
        ConstantMedium(Box((0.1, -0.5, -2.0), (1.1, 0.5, -1.0),
                           Lambertian((1, 1, 1))),
                       0.7, (0.2, 0.5, 0.9)),
        Quad((-4.0, -4.0, -4.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0),
             DiffuseLight((5.0, 5.0, 5.0))),
    )
    desc.camera = Camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90.0,
                         focus_dist=1.0, background=(0.0, 0.0, 0.0))
    return desc


@pytest.mark.parametrize("case,minfrac", [
    ("s0", 0.97),           # spheres, checker, moving, defocus
    ("s2", 0.99),           # image texture on a sphere
    ("s3", 0.90),           # Perlin marble: turbulence amplifies ulps
    ("s4", 1.0),            # quads
    ("s5", 0.90),           # marble + lights
    ("s8", 0.95),           # rotated box media
    ("multi_image", 0.99),  # two images + quad UV
    ("multi_noise", 0.90),  # two Perlin tables
])
def test_replay_matches_search_radiance(case, minfrac):
    desc = {"multi_image": _multi_image, "multi_noise": _multi_noise}.get(
        case, lambda: scenes.build_scene(int(case[1:])))()
    scene, meta, tape, acc, o, d, t, pc = _setup_desc(desc)
    r = np.asarray(rp.replay(scene, meta, tape, o, d, t, pc, jnp.uint32(0),
                             max_bounces=K, t_min=1e-3))
    acc = np.asarray(acc)
    assert np.isfinite(r).all()
    close = np.isclose(r, acc, rtol=1e-3, atol=5e-4).all(axis=-1)
    assert close.mean() >= minfrac, close.mean()


def test_all_param_grads_finite():
    """Every trainable leaf's gradient (geometry, material scalars, colors,
    camera incl. background) is finite through the replay, under jit with
    traced camera leaves."""
    from raytracinginoneweekendincuda_tpu.parallel.train import (
        merge_params, split_params,
    )

    scene, meta, tape, _, o, d, t, pc = _setup_desc(scenes.build_scene(0))
    params = split_params(scene)

    def L(p):
        sc = merge_params(scene, p)
        return rp.replay(sc, meta, tape, o, d, t, pc, jnp.uint32(0),
                         max_bounces=K, t_min=1e-3).sum()

    grads = jax.jit(jax.grad(L))(params)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        assert bool(jnp.isfinite(g).all()), path
    # the background gradient is real (miss lanes: d(loss)/d(bg) = thr)
    assert float(jnp.abs(grads["camera"].background).max()) > 0.0


def _fd_check(L, v0, rtol=5e-2):
    g = float(jax.grad(L)(v0))
    eps = 1e-3
    fd = (float(L(v0 + eps)) - float(L(v0 - eps))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g) > 0.0, "vacuous: pick a parameter the loss depends on"
    np.testing.assert_allclose(g, fd, rtol=rtol)


@pytest.mark.parametrize("med", [0, 1])
def test_medium_albedo_grad_matches_fd(med):
    """d(loss)/d(medium albedo) == central FD of the replay, for a
    sphere-boundary (0) and a box-boundary (1) constant medium."""
    scene, meta, tape, _, o, d, t, pc = _setup_desc(_media_probe())
    ti = int(np.asarray(scene.mat_tex)[int(np.asarray(scene.med_mat)[med])])
    idx = (ti, 1)

    def L(v):
        sc = scene._replace(tex_c0=scene.tex_c0.at[idx].set(v))
        return rp.replay(sc, meta, tape, o, d, t, pc, jnp.uint32(0),
                         max_bounces=K, t_min=1e-3).sum()

    _fd_check(L, scene.tex_c0[idx])


def test_albedo_grad_matches_fd():
    """Scene 0 (spheres, checker, moving): a color-table gradient."""
    scene, meta, tape, _, o, d, t, pc = _setup_desc(scenes.build_scene(0))
    wgt = jnp.arange(W * H * 3, dtype=jnp.float32).reshape(-1, 3) * 1e-3

    def L(v):
        sc = scene._replace(tex_c0=scene.tex_c0.at[0, 1].set(v))
        return (rp.replay(sc, meta, tape, o, d, t, pc, jnp.uint32(0),
                          max_bounces=K, t_min=1e-3) * wgt).sum()

    _fd_check(L, scene.tex_c0[0, 1])


def test_geometry_grad_matches_fd():
    """Marble (continuous Perlin) makes radiance depend on the hit POINT,
    so a sphere-center gradient is real; FD of the replay confirms it."""
    scene, meta, tape, _, o, d, t, pc = _setup_desc(scenes.perlin_spheres())

    def L(v):
        sc = scene._replace(sph_c0=scene.sph_c0.at[1, 0].set(v))
        return rp.replay(sc, meta, tape, o, d, t, pc, jnp.uint32(0),
                         max_bounces=K, t_min=1e-3).sum()

    _fd_check(L, scene.sph_c0[1, 0], rtol=0.1)


def test_ray_time_cotangents_zero_and_finite():
    """d(loss)/d(o, d, time) are finite and EXACTLY zero on scene 0: with
    solid/checker textures the taped radiance depends on geometry only
    through `floor` cells and branch predicates, so the pathwise
    derivative vanishes a.e.  Guards the NaN channel of masked lanes."""
    scene, meta, tape, _, o, d, t, pc = _setup_desc(scenes.build_scene(0))
    wgt = jnp.arange(W * H * 3, dtype=jnp.float32).reshape(-1, 3) * 1e-3

    def L(o_, d_, t_):
        return (rp.replay(scene, meta, tape, o_, d_, t_, pc, jnp.uint32(0),
                          max_bounces=K, t_min=1e-3) * wgt).sum()

    for g in jax.grad(L, argnums=(0, 1, 2))(o, d, t):
        g = np.asarray(g)
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, np.zeros_like(g))
