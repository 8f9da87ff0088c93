"""Multi-chip semantics on the simulated 8-device CPU mesh (SURVEY.md §4(f)).

The sharding contract: the counter RNG keys on *global* pixel/sample ids, so
a sharded render must be bit-identical to the single-chip render on the same
backend — the layout is an implementation detail, like the reference's block
size (`kernel.cu:575-576`, any block shape gives the same image).
"""

import jax
import numpy as np
import optax
import pytest

from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops.render import render
from raytracinginoneweekendincuda_tpu.parallel import train
from raytracinginoneweekendincuda_tpu.parallel.render import (
    AXIS_PX, AXIS_SP, make_mesh, render_sharded,
)
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_render_matches_single_chip(shape):
    """Pixel sharding is bit-identical (same per-pixel sum order); sample
    sharding reassociates the f32 sample sum (partials + psum), so it is
    equal to within 1-2 ulp."""
    n_px, n_sp = shape
    devs = jax.devices()[: n_px * n_sp]
    mesh = make_mesh(devs, sample_shards=n_sp)
    W, H, spp = 32, 16, 4
    desc = scenes.quads()
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp)
    ref = np.asarray(render(scene, meta, cfg), np.float32)
    img = np.asarray(render_sharded(scene, meta, cfg, mesh), np.float32)
    if n_sp == 1:
        np.testing.assert_array_equal(img, ref)
    else:
        np.testing.assert_allclose(img, ref, atol=5e-7, rtol=5e-7)


def test_sharded_render_media_scene():
    # cornell_smoke exercises the medium candidates + black background
    mesh = make_mesh(jax.devices()[:4], sample_shards=2)
    W, H, spp = 16, 16, 2
    scene, meta = compile_scene(scenes.cornell_smoke(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp)
    ref = np.asarray(render(scene, meta, cfg), np.float32)
    img = np.asarray(render_sharded(scene, meta, cfg, mesh), np.float32)
    np.testing.assert_allclose(img, ref, atol=5e-7, rtol=5e-7)


def test_train_step_runs_and_matches_single_device_grads():
    """Sharded grad == unsharded grad (up to f32 reduction order)."""
    W, H, spp = 16, 8, 4
    scene, meta = compile_scene(scenes.book1_basic(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp, max_bounces=6)
    npix = W * H
    pix = np.arange(npix, dtype=np.int32)
    target = np.full((npix, 3), 0.25, np.float32)

    def run(mesh):
        optimizer = optax.sgd(0.0)  # lr 0: state.params stay fixed for grad compare
        state = train.init_state(scene, optimizer)
        step = train.make_train_step(scene, meta, cfg, mesh, optimizer)
        _, loss = step(state, scene, pix, target)
        return float(loss)

    loss_1 = run(make_mesh(jax.devices()[:1], sample_shards=1))
    loss_8 = run(make_mesh(jax.devices()[:8], sample_shards=2))
    assert np.isfinite(loss_1) and np.isfinite(loss_8)
    np.testing.assert_allclose(loss_1, loss_8, rtol=1e-5)


def test_train_step_reduces_loss():
    """A few Adam steps on sphere albedo/geometry should reduce MSE toward a
    target rendered from a perturbed scene (self-consistency of gradients)."""
    W, H, spp = 16, 8, 4
    scene, meta = compile_scene(scenes.book1_basic(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp, max_bounces=6)
    mesh = make_mesh(jax.devices()[:4], sample_shards=2)

    # target: the same scene with brighter albedo, rendered in linear radiance
    bright = scene._replace(tex_c0=np.clip(scene.tex_c0 * 1.6, 0, 1))
    target_img = render_sharded(bright, meta, cfg, mesh, gamma=False)
    npix = W * H
    target = np.asarray(target_img[::-1].reshape(npix, 3), np.float32)
    pix = np.arange(npix, dtype=np.int32)

    optimizer = optax.adam(2e-2)
    state = train.init_state(scene, optimizer)
    step = train.make_train_step(scene, meta, cfg, mesh, optimizer)
    losses = []
    for _ in range(8):
        state, loss = step(state, scene, pix, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_mega2_matches_single_chip(shape):
    """The megakernel per shard (strided pixel lanes + global sample base
    via the samp0 scalar) reproduces the one-device mega2 image: RNG keys
    on global (pixel, sample) ids, so the mesh layout is invisible up to
    f32 sample-sum association and the host-vs-device gamma epilogue."""
    n_px, n_sp = shape
    mesh = make_mesh(jax.devices()[: n_px * n_sp], sample_shards=n_sp)
    W, H, spp = 24, 12, 4
    scene, meta = compile_scene(scenes.quads(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       engine="mega2")
    ref = np.asarray(render(scene, meta, cfg), np.float32)
    img = np.asarray(render_sharded(scene, meta, cfg, mesh), np.float32)
    np.testing.assert_allclose(img, ref, atol=5e-7, rtol=5e-7)


def test_sharded_mega2_noise_scene():
    # simple_light: Perlin marble -> the perm/vec tables ride the shard_map
    mesh = make_mesh(jax.devices()[:4], sample_shards=2)
    W, H, spp = 16, 12, 2
    scene, meta = compile_scene(scenes.simple_light(), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       engine="mega2")
    ref = np.asarray(render(scene, meta, cfg), np.float32)
    img = np.asarray(render_sharded(scene, meta, cfg, mesh), np.float32)
    np.testing.assert_allclose(img, ref, atol=5e-7, rtol=5e-7)


def test_sharded_mega2_train_step_matches_single_chip():
    """The fast gradient path composed over the mesh
    (`make_train_step_mega2(mesh=...)`: per-shard megakernel trace tape +
    XLA replay, radiance psum over sp, gradient psum over both axes)
    matches the one-device fast step — same tapes (global-id RNG), same
    replay function — up to f32 psum reassociation."""
    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.quads(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_bounces=3)
    npix = W * H
    pix = np.arange(npix, dtype=np.int32)
    target = np.full((npix, 3), 0.25, np.float32)
    # plain SGD: the update is proportional to the gradient, so a mesh
    # that scaled gradients (Adam would normalize that away) fails here
    optimizer = optax.sgd(1e-2)

    def run(mesh):
        state = train.init_state(scene, optimizer)
        step = train.make_train_step_mega2(scene, meta, cfg, optimizer,
                                           mesh=mesh)
        state2, loss = step(state, pix, target)
        return float(loss), state2.params

    loss_8, p8 = run(make_mesh(jax.devices()[:8], sample_shards=2))
    # single chip through the same implementation (1x1 mesh)
    loss_1, p1 = run(make_mesh(jax.devices()[:1], sample_shards=1))
    np.testing.assert_allclose(loss_8, loss_1, rtol=1e-6)
    diffs = jax.tree.map(
        lambda a, b: float(abs(np.asarray(a) - np.asarray(b)).max()), p8, p1)
    assert max(jax.tree.leaves(diffs)) < 3e-6, diffs

    # and against the two-phase one-device fast step (mesh=None): same
    # tapes, same XLA replay
    state = train.init_state(scene, optimizer)
    step0 = train.make_train_step_mega2(scene, meta, cfg, optimizer)
    state0, loss_0 = step0(state, pix, target)
    np.testing.assert_allclose(loss_1, float(loss_0), rtol=1e-6)
    p0 = state0.params
    np.testing.assert_allclose(np.asarray(p1["tex_c0"]),
                               np.asarray(p0["tex_c0"]), atol=3e-6)


def test_mega2_tapes_scattered_ids():
    """Scattered pixel minibatches (the inverse-rendering regime) produce
    the same tapes as the contiguous whole-frame dispatch, gathered."""
    from raytracinginoneweekendincuda_tpu.ops.mega2 import mega2_tapes

    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.quads(), W, H, dtype=np.float32)
    full = np.asarray(mega2_tapes(scene, meta, np.arange(W * H), spp,
                                  width=W, height=H, max_bounces=4,
                                  t_min=1e-3, seed=1984))
    rng = np.random.default_rng(7)
    ids = rng.permutation(W * H)[:37].astype(np.int32)
    got = np.asarray(mega2_tapes(scene, meta, ids, spp, width=W, height=H,
                                 max_bounces=4, t_min=1e-3, seed=1984))
    np.testing.assert_array_equal(got, full[:, :, ids])


@pytest.mark.parametrize("engine", ["wavefront", "wavefront_bvh"])
def test_sharded_wavefront_matches_single_chip(engine):
    """Per-shard persistent pools over contiguous pixel windows + sample
    slices must reproduce the single-chip wavefront image (global-id RNG)."""
    mesh = make_mesh(jax.devices()[:4], sample_shards=2)
    W, H, spp = 24, 12, 4
    scene, meta = compile_scene(scenes.quads(), W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       rays_per_batch=512, engine=engine)
    from raytracinginoneweekendincuda_tpu.ops.render import render as r1
    ref = np.asarray(r1(scene, meta, cfg), np.float32)
    img = np.asarray(render_sharded(scene, meta, cfg, mesh), np.float32)
    np.testing.assert_allclose(img, ref, atol=5e-7, rtol=5e-7)


@pytest.mark.parametrize("scene_id,W,H", [(0, 128, 64), (9, 64, 32)])
def test_px_shard_work_balance(scene_id, W, H):
    """Scaling is measured, not asserted 'by construction': with STRIDED
    pixel assignment every px shard samples the whole image interleaved,
    so per-shard work (total bounce segments) balances to Monte-Carlo
    noise.  The bound here is the scaling-efficiency floor: <10%
    imbalance => >90% px-axis scaling efficiency at equal per-shard
    throughput."""
    from raytracinginoneweekendincuda_tpu.parallel.render import (
        shard_work_stats,
    )

    scene, meta = compile_scene(scenes.build_scene(scene_id), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2,
                       engine="mega2")
    segs = shard_work_stats(scene, meta, cfg)
    s = segs.astype(float)
    assert s.min() > 0, f"a px shard did no work: {segs}"
    imbal = s.max() / s.mean()
    assert imbal < 1.10, f"px-shard imbalance {imbal:.3f} >= 1.10: {segs}"


def test_sharded_statics_quantization_boundary():
    """The sharded fast-grad step's compiled kernel keys on the table
    LAYOUT, not on geometry values (the tables are kernel inputs): (a) a
    large geometry move does not recompile and the step matches a FRESH
    factory's step bit-for-bit (no stale-cache corruption); (b) a small
    move does not recompile either."""
    from raytracinginoneweekendincuda_tpu.core.camera import Camera
    from raytracinginoneweekendincuda_tpu.scene.api import (
        Lambertian, SceneDesc, Sphere,
    )

    desc = SceneDesc()
    for k in range(6):
        desc.add(Sphere((0.7 * (k % 3), 0.7 * (k // 3), -0.2 * k), 0.5,
                        Lambertian((0.3 + 0.1 * k, 0.5, 0.9 - 0.1 * k))))
    desc.camera = Camera(lookfrom=(0.7, 0.35, 6), lookat=(0.7, 0.35, 0),
                         vfov=40.0, background=(0.7, 0.8, 1.0))
    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(desc, W, H, dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_bounces=3)
    pix = np.arange(W * H, dtype=np.int32)
    target = np.full((W * H, 3), 0.25, np.float32)
    optimizer = optax.sgd(1e-3)
    mesh = make_mesh(jax.devices()[:2], sample_shards=1)

    step = train.make_train_step_mega2(scene, meta, cfg, optimizer,
                                       mesh=mesh)
    state = train.init_state(scene, optimizer)
    state1, loss1 = step(state, pix, target)
    assert len(step.cache) == 1 and np.isfinite(float(loss1))

    # (b) small move -> no new kernel variant
    small = dict(state1.params)
    small["sph_c0"] = state1.params["sph_c0"] + 1e-4
    state_s = train.TrainState(small, state1.opt_state, state1.step)
    step(state_s, pix, target)
    assert len(step.cache) == 1, "a geometry move must not retrace"

    # (a) large move -> still one variant, and it matches a fresh factory
    big = dict(state1.params)
    big["sph_c0"] = state1.params["sph_c0"] + 0.05
    state_b = train.TrainState(big, state1.opt_state, state1.step)
    state2, loss2 = step(state_b, pix, target)
    assert len(step.cache) == 1, "a geometry move must not retrace"
    assert np.isfinite(float(loss2))

    fresh = train.make_train_step_mega2(scene, meta, cfg, optimizer,
                                        mesh=mesh)
    state2f, loss2f = fresh(state_b, pix, target)
    np.testing.assert_allclose(float(loss2), float(loss2f), rtol=0, atol=0)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        state2.params, state2f.params)


def test_sharded_taped_train_step_marble_geometry_grads():
    """Raise the mesh-composition evidence from quads (where geometry
    gradients vanish: flat colors, no hit-point-dependent shading) to a
    TEXTURED scene: perlin_spheres' marble makes the radiance depend on
    the hit POINT through turbulence->sin (marble x sky paths), so
    `sph_c0` gradients are genuinely nonzero through the backward
    (|g|~1.7e3 at this size).  This caught the check_vma=False
    psum-transpose double-count: differentiating *through* the sample
    psum scaled every gradient by n_sp (train.py shard_body now applies
    the MSE chain rule outside autodiff).  Runs the taped XLA-replay
    engine on the CPU mesh — the megakernel fast-grad variant is
    `test_sharded_mega2_train_step_marble` below."""
    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.perlin_spheres(), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_bounces=3)
    pix = np.arange(W * H, dtype=np.int32)
    target = np.full((W * H, 3), 0.25, np.float32)
    optimizer = optax.sgd(1e-2)

    def run(mesh):
        state = train.init_state(scene, optimizer)
        step = train.make_train_step(scene, meta, cfg, mesh, optimizer,
                                     engine="taped")
        state2, loss = step(state, scene, pix, target)
        return float(loss), state2.params

    loss_8, p8 = run(make_mesh(jax.devices()[:8], sample_shards=2))
    loss_1, p1 = run(make_mesh(jax.devices()[:1], sample_shards=1))
    np.testing.assert_allclose(loss_8, loss_1, rtol=1e-6)
    # Compare the UPDATES (params - init = -lr * grad) relatively: marble
    # gradients are large and sign-oscillating (sin(scale*z + 10*turb)),
    # so the sharded psum's f32 reassociation error scales with the
    # gradient magnitude, not with machine epsilon of the params.  1e-3
    # relative on the update (plus a tiny absolute floor for zero-grad
    # leaves) is ~1000x above reassociation noise-free equality but far
    # below any wrong-gradient failure mode (a dropped shard, a double
    # psum, a stale tape all shift updates O(1) relative).
    init = train.init_state(scene, optax.sgd(1e-2)).params

    def upd(p, p0):
        return np.asarray(p) - np.asarray(p0)

    for leaf in p8:
        for a, b, c in zip(jax.tree.leaves(p8[leaf]),
                           jax.tree.leaves(p1[leaf]),
                           jax.tree.leaves(init[leaf])):
            d8, d1 = upd(a, c), upd(b, c)
            scale = np.abs(d1).max()
            tol = 1e-3 * scale + 1e-7
            assert np.abs(d8 - d1).max() <= tol, (
                leaf, float(np.abs(d8 - d1).max()), float(scale))

    # the POINT of marble: geometry actually moved (nonzero sph_c0 grad)
    dmove = np.abs(np.asarray(p8["sph_c0"]) - np.asarray(scene.sph_c0))
    assert dmove.max() > 1e-7, "marble scene should produce geometry grads"


def test_sharded_mega2_train_step_marble():
    """The fast-grad mesh composition on a textured scene: same comparison
    as the taped test above but through `make_train_step_mega2(mesh=...)`
    (per-shard megakernel tape + XLA replay), pinning the 1x1-mesh
    composed path against the two-phase one-device step (same tapes, same
    replay)."""
    W, H, spp = 16, 8, 2
    scene, meta = compile_scene(scenes.perlin_spheres(), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_bounces=3)
    pix = np.arange(W * H, dtype=np.int32)
    target = np.full((W * H, 3), 0.25, np.float32)
    optimizer = optax.sgd(1e-2)

    mesh = make_mesh(jax.devices()[:1], sample_shards=1)
    state = train.init_state(scene, optimizer)
    step = train.make_train_step_mega2(scene, meta, cfg, optimizer,
                                       mesh=mesh)
    state1, loss1 = step(state, pix, target)

    state0 = train.init_state(scene, optimizer)
    step0 = train.make_train_step_mega2(scene, meta, cfg, optimizer)
    state0, loss0 = step0(state0, pix, target)
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-5)
    dmove = np.abs(np.asarray(state1.params["sph_c0"])
                   - np.asarray(scene.sph_c0))
    assert dmove.max() > 1e-7, "marble scene should produce geometry grads"
