#!/usr/bin/env python3
"""Smoke test of the path tracer on one NVIDIA GPU, through the entry
points a user calls, at the reference's full frame size.

    python chip_smoke.py                # one card: phases 0-5 and gpu tests
    python chip_smoke.py --four-gpus    # four cards: the mesh phase only

Phases (each one fails the run if it fails):
  0  device      card name and power limit, JAX version, XLA_FLAGS; a GPU
  1  compile     the megakernel at real widths (render: scene 0 at
                 1440x720@10, scene 9 at 1440x720@100; trace mode at the
                 train-step shape), compile seconds and memory analysis
  2  main path   `utils.cli.main` renders scene 9 at 1440x720@100 and scene
                 0 at 1440x720@10 to PPM; header, value range, orientation,
                 and the earth texture loaded
  3  parity      megakernel vs the plain `bruteforce` engine (f32, no TF32)
                 at the same seed, against the seed-to-seed noise floor
  4  timing      megakernel vs the XLA engines after warm-up: best of 3
                 for the kernel and `wavefront`, one call for the rest
  5  gradient    `make_train_step_mega2` Adam steps; tapes vs the XLA
                 search tape; replay gradient vs the scan oracle
  then the tests marked ``gpu`` (tests/test_gpu.py).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Long output goes to --out (default chiprun_out/smoke).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cuda")

from raytracinginoneweekendincuda_tpu.utils.benchmark import (  # noqa: E402
    card_line, require_gpu,
)

W, H = 1440, 720                 # the reference's frame (kernel.cu:572-573)
TRAIN = (640, 360, 8, 8)         # train step: width, height, spp, bounces
PARITY9 = (720, 360)             # scene-9 parity frame
GRAD = (64, 48)                  # replay-vs-oracle gradient frame


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: ok ({time.perf_counter() - self.t0:.1f} s)")
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def scene_of(sid: int, w: int, h: int):
    import numpy as np

    from raytracinginoneweekendincuda_tpu.models.scenes import build_scene
    from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene

    return compile_scene(build_scene(sid), w, h, dtype=np.float32)


def timed(fn, repeats: int = 3):
    """(first call seconds, best of ``repeats`` seconds, last output); every
    call ends at device completion."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def phase_compile(card: str) -> None:
    import jax.numpy as jnp

    from raytracinginoneweekendincuda_tpu.ops import mega2
    from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

    for sid, spp in ((0, 10), (9, 100)):
        scene, meta = scene_of(sid, W, H)
        tabs, layout, med, _ = mega2.mega2_tables(scene, meta)
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp)
        spec = mega2.kernel_spec(scene, meta, layout, med, seed=cfg.seed,
                                 max_bounces=cfg.max_bounces,
                                 t_min=cfg.t_min)
        t0 = time.perf_counter()
        compiled = mega2.render_mega2_frame.trace(
            tabs, jnp.int32(spp), spec=spec, width=W, height=H, gamma=True,
            out_u8=True, interpret=False).lower().compile()
        log(f"compile render scene {sid} {W}x{H}@{spp}: "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{compiled.memory_analysis()}")
    # the train step's tapes
    tw, th, spp, k = TRAIN
    scene, meta = scene_of(0, tw, th)
    tabs, layout, med, remap = mega2.mega2_tables(scene, meta)
    spec = mega2.kernel_spec(scene, meta, layout, med, seed=1984,
                             max_bounces=k, t_min=1e-3)
    t0 = time.perf_counter()
    compiled = mega2._tapes_jit.trace(
        tabs, remap, jnp.arange(tw * th, dtype=jnp.int32), spec=spec,
        width=tw, height=th, n_samples=spp, interpret=False).lower().compile()
    log(f"compile trace {tw}x{th}x{spp} samples, K={k}: "
        f"{time.perf_counter() - t0:.1f} s; {compiled.memory_analysis()}")


def read_ppm(path: str):
    import numpy as np

    with open(path) as f:
        tokens = f.read().split()
    check(tokens[0] == "P3", f"{path}: not a P3 PPM")
    w, h, mx = int(tokens[1]), int(tokens[2]), int(tokens[3])
    px = np.asarray(tokens[4:], np.int32)
    check(mx == 255 and px.size == w * h * 3, f"{path}: bad header/size")
    return px.reshape(h, w, 3)


def phase_main_path(out_dir: str) -> None:
    import numpy as np

    from raytracinginoneweekendincuda_tpu.utils import cli

    for sid, spp in ((9, 100), (0, 10)):
        path = os.path.join(out_dir, f"scene{sid}_{W}x{H}_{spp}spp.ppm")
        t0 = time.perf_counter()
        rc = cli.main(["--scene", str(sid), "--width", str(W), "--height",
                       str(H), "--spp", str(spp), "--out", path,
                       "--png", path[:-4] + ".png"])
        check(rc == 0, f"cli returned {rc}")
        img = read_ppm(path)
        log(f"cli scene {sid} {W}x{H}@{spp}: {time.perf_counter() - t0:.1f} "
            f"s incl. compile; mean {img.mean():.2f}/255")
        check(img.shape == (H, W, 3), f"shape {img.shape}")
        check(0 <= img.min() and img.max() <= 255, "values out of range")
        check(img.max() > 0, "black frame")
        check(np.abs(img[:H // 4].mean() - img[-H // 4:].mean()) > 1.0,
              "top rows equal bottom rows")
    # scene 9's earth: the texel table is the decoded map, so the kernel's
    # debug cyan (a missing image) cannot occur
    scene, meta = scene_of(9, 64, 32)
    img = np.asarray(scene.img_data)[0]
    check(meta.n_images == 1 and img.std() > 0.05,
          "earth texture missing: scene 9 would render a cyan globe")


def parity(sid: int, w: int, h: int, spp: int) -> dict:
    """Megakernel vs bruteforce at seed 1984, with bruteforce at seed 31337
    as the Monte-Carlo noise floor."""
    import numpy as np

    from raytracinginoneweekendincuda_tpu.ops.render import render
    from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

    scene, meta = scene_of(sid, w, h)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp)
    img = np.asarray(render(scene, meta, cfg.with_(engine="mega2")),
                     np.float64)
    ref = np.asarray(render(scene, meta, cfg), np.float64)
    ref2 = np.asarray(render(scene, meta, cfg.with_(seed=31337)), np.float64)
    d = np.abs(img - ref)
    noise = float(np.percentile(np.abs(ref2 - ref), 99))
    return {
        "p99_over_noise": float(np.percentile(d, 99)) / max(noise, 1e-9),
        "rerolled": float((d.max(-1) > 1e-3).mean()),
        "mean_rel": abs(img.mean() - ref.mean()) / ref.mean(),
    }


def phase_parity() -> None:
    for sid, w, h in ((0, W, H), (9, *PARITY9)):
        r = parity(sid, w, h, 10)
        log(f"parity scene {sid} {w}x{h}@10: p99/noise "
            f"{r['p99_over_noise']:.4f} (<= 0.5), re-rolled "
            f"{100 * r['rerolled']:.3f}% (<= 5%), frame mean off by "
            f"{100 * r['mean_rel']:.4f}% (<= 0.5%)")
        check(r["p99_over_noise"] <= 0.5, "p99 above half the noise floor")
        check(r["rerolled"] <= 0.05, "more than 5% of pixels re-rolled")
        check(r["mean_rel"] <= 0.005, "frame means differ by more than 0.5%")


# XLA engines that the full table (PERF.md) showed to be far slower than
# `wavefront`, the best of them: one timed call after warm-up each, which
# keeps the smoke test's chip time bounded
ONE_RUN = ("bruteforce", "bvh", "wavefront_bvh")


def phase_timing(card: str) -> None:
    import numpy as np

    from raytracinginoneweekendincuda_tpu.ops.render import render
    from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

    for sid in (0, 9):
        scene, meta = scene_of(sid, W, H)
        best = {}
        for engine in ("mega2", "wavefront") + ONE_RUN:
            cfg = RenderConfig(width=W, height=H, samples_per_pixel=10,
                               engine=engine)
            n = 1 if engine in ONE_RUN else 3
            first, best[engine], img = timed(lambda: render(
                scene, meta, cfg, out_u8=True,
                device_out=engine == "mega2"), repeats=n)
            check(np.asarray(img).any(), f"{engine}: empty frame")
            log(f"timing scene {sid} {W}x{H}@10 {engine:13s}: best of {n} "
                f"{best[engine]:.4f} s "
                f"({W * H * 10 / best[engine] / 1e6:.2f} M rays/s), first "
                f"call {first:.1f} s [{card}]")
        xla = min(v for k, v in best.items() if k != "mega2")
        check(best["mega2"] < xla,
              f"scene {sid}: the megakernel lost to the XLA engines")


def phase_gradient(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from raytracinginoneweekendincuda_tpu.ops import mega2, replay
    from raytracinginoneweekendincuda_tpu.ops.integrator import trace
    from raytracinginoneweekendincuda_tpu.ops.raygen import generate_rays
    from raytracinginoneweekendincuda_tpu.parallel import train
    from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

    tw, th, spp, k = TRAIN
    scene, meta = scene_of(0, tw, th)
    cfg = RenderConfig(width=tw, height=th, samples_per_pixel=spp,
                       max_bounces=k)
    pix = np.arange(tw * th, dtype=np.int32)
    target = np.full((tw * th, 3), 0.25, np.float32)
    opt = optax.adam(1e-2)
    state = train.init_state(scene, opt)
    step = train.make_train_step_mega2(scene, meta, cfg, opt)
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        state, loss = step(state, pix, target)
        loss = float(loss)
        losses.append(loss)
        log(f"train step {i} (scene 0, K={k}, {tw}x{th}@{spp}): loss "
            f"{loss:.6f}, {time.perf_counter() - t0:.2f} s [{card}]")
        check(np.isfinite(loss), "non-finite loss")
    moved = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(state.params),
        jax.tree.leaves(train.init_state(scene, opt).params)))
    check(moved > 0.0, "parameters did not move")

    # tapes: the kernel's vs the XLA search tape, per (bounce, lane)
    tape_k = np.asarray(mega2.mega2_tapes(
        scene, meta, pix, 1, width=tw, height=th, max_bounces=k,
        t_min=cfg.t_min, seed=cfg.seed))[0]
    sj = jax.tree.map(jnp.asarray, scene)
    o, d, t, pc = generate_rays(sj.camera, jnp.asarray(pix), jnp.uint32(0),
                                tw, th, cfg.seed)
    tape_x, _ = jax.jit(lambda o, d, t, pc: replay.generate_tape(
        sj, meta, o, d, t, pc, jnp.uint32(0), max_bounces=k,
        t_min=cfg.t_min))(o, d, t, pc)
    agree = float((tape_k == np.asarray(tape_x)).mean())
    log(f"tape agreement kernel vs XLA search: {100 * agree:.3f}% (>= 99%)")
    check(agree >= 0.99, "tapes disagree on more than 1% of entries")

    # replay gradient vs the scan oracle at 2 spp, K bounces
    gw, gh = GRAD
    scene, meta = scene_of(0, gw, gh)
    sj = jax.tree.map(jnp.asarray, scene)
    gpix = jnp.arange(gw * gh, dtype=jnp.int32)

    def loss_of(fn):
        def f(params):
            sc = train.merge_params(sj, params)
            img = 0.0
            for s in range(2):
                o, d, t, pc = generate_rays(sc.camera, gpix, jnp.uint32(s),
                                            gw, gh, cfg.seed)
                img = img + fn(sc, meta, o, d, t, pc, jnp.uint32(s),
                               max_bounces=k, t_min=cfg.t_min)
            return ((img / 2 - 0.25) ** 2).sum()
        return jax.jit(jax.grad(f))

    params = train.split_params(sj)
    g_r = loss_of(replay.trace_taped)(params)
    g_o = loss_of(lambda *a, **kw: trace(*a, differentiable=True, **kw))(
        params)
    num = sum(float(jnp.abs(a - b).sum()) for a, b in zip(
        jax.tree.leaves(g_r), jax.tree.leaves(g_o)))
    den = sum(float(jnp.abs(b).sum()) for b in jax.tree.leaves(g_o))
    log(f"replay vs scan-oracle gradient rel-L1: {num / den:.2e} (<= 1e-2)")
    check(num / den <= 1e-2, "replay gradient disagrees with the oracle")


def phase_gpu_tests() -> None:
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-o", "addopts=", "-q", "-m", "gpu", "-p",
                      "no:cacheprovider", os.path.join(here, "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def phase_four_gpus() -> None:
    import jax
    import numpy as np
    import optax

    from raytracinginoneweekendincuda_tpu.ops.render import render
    from raytracinginoneweekendincuda_tpu.parallel import train
    from raytracinginoneweekendincuda_tpu.parallel.render import (
        make_mesh, render_sharded,
    )
    from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

    devs = jax.devices()
    check(len(devs) == 4, f"--four-gpus needs 4 GPUs, found {len(devs)}")
    scene, meta = scene_of(0, W, H)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=10,
                       engine="mega2")
    one = np.asarray(render(scene, meta, cfg))
    for shape, tol in (((4, 1), 0.0), ((2, 2), 1e-5)):
        mesh = make_mesh(devs, sample_shards=shape[1])
        t0 = time.perf_counter()
        img = np.asarray(render_sharded(scene, meta, cfg, mesh))
        err = float(np.abs(img - one).max())
        log(f"render_sharded scene 0 {W}x{H}@10 on (px={shape[0]}, "
            f"sp={shape[1]}): max |diff| vs one card {err:.3e} (<= {tol}), "
            f"{time.perf_counter() - t0:.1f} s incl. compile")
        check(err <= tol, f"mesh {shape} differs from the one-card render")

    tw, th = 320, 180
    scene, meta = scene_of(0, tw, th)
    tcfg = RenderConfig(width=tw, height=th, samples_per_pixel=4,
                        max_bounces=8)
    pix = np.arange(tw * th, dtype=np.int32)
    target = np.full((tw * th, 3), 0.25, np.float32)
    opt = optax.sgd(1e-2)
    results = []
    for mesh in (make_mesh(devs, sample_shards=2),
                 make_mesh(devs[:1], sample_shards=1)):
        step = train.make_train_step_mega2(scene, meta, tcfg, opt, mesh=mesh)
        st, loss = step(train.init_state(scene, opt), pix, target)
        results.append((float(loss), st.params))
    (l4, p4), (l1, p1) = results
    upd = [float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
           zip(jax.tree.leaves(p4), jax.tree.leaves(p1))]
    scale = max(float(np.abs(np.asarray(b) - np.asarray(c)).max())
                for b, c in zip(jax.tree.leaves(p1), jax.tree.leaves(
                    train.init_state(scene, opt).params)))
    log(f"sharded train step (2x2) vs one card: loss {l4:.7f} vs {l1:.7f}, "
        f"max param diff {max(upd):.2e} (update scale {scale:.2e})")
    check(abs(l4 - l1) <= 1e-5 * abs(l1), "sharded loss differs")
    check(max(upd) <= 1e-3 * scale + 1e-7, "sharded gradients differ")
    for d in devs:
        used = d.memory_stats()["peak_bytes_in_use"]
        log(f"{d}: peak bytes in use {used}")
        check(used > 0, f"{d} did no work")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-card mesh phase")
    p.add_argument("--out", default=os.path.join("chiprun_out", "smoke"))
    args = p.parse_args()

    import jax

    with Phase("phase 0: device"):
        card = card_line()
        log(f"card: {card}")
        log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
        dev = require_gpu()
        log(f"devices: {jax.devices()}")

    from raytracinginoneweekendincuda_tpu.utils.cache import (
        enable_compile_cache,
    )

    log(f"compile cache: {enable_compile_cache()}")
    os.makedirs(args.out, exist_ok=True)
    if args.four_gpus:
        with Phase("four GPUs: mesh render and train step"):
            phase_four_gpus()
    else:
        with Phase("phase 1: compile"):
            phase_compile(card)
        with Phase("phase 2: main path (CLI)"):
            phase_main_path(args.out)
        with Phase("phase 3: parity with bruteforce"):
            phase_parity()
        with Phase("phase 4: engine timing"):
            phase_timing(card)
        with Phase("phase 5: gradient"):
            phase_gradient(card)
        with Phase("gpu-marked tests"):
            phase_gpu_tests()
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
