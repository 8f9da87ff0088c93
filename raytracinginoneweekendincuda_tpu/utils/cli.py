"""Command-line renderer — the product surface of the framework.

The reference has no CLI: resolution / scene / spp are compile-time constants
in ``main()`` (`kernel.cu:572-593`) and switching scenes means editing and
rebuilding.  Here the same knobs are flags; defaults match the reference
(1440x720, scene 9, per-scene spp per kernel.cu:593, seed 1984).

Usage:
    python -m raytracinginoneweekendincuda_tpu.utils.cli \
        --scene 4 --width 240 --height 135 --spp 10 --out out.ppm [--cpu]

Notes: ``--cpu`` must flip the backend *before* JAX initializes, so all heavy
imports happen inside ``main`` after argument parsing.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtow-render", description=__doc__)
    p.add_argument("--scene", type=int, default=9, help="scene id 0-9 (kernel.cu:578-589)")
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (default: reference per-scene choice)")
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--seed", type=int, default=1984)
    p.add_argument("--out", type=str, default="output.ppm")
    p.add_argument("--png", type=str, default=None, help="also write a PNG here")
    p.add_argument("--engine", default="mega2",
                   choices=("bruteforce", "bvh", "wavefront", "wavefront_bvh",
                            "mega2"),
                   help="mega2 = pixel-per-lane GPU megakernel (the fast "
                        "path); bruteforce = chunked XLA reference engine")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (kernels run interpreted)")
    p.add_argument("--sharded", action="store_true",
                   help="render via shard_map over all visible devices")
    p.add_argument("--rays-per-batch", type=int, default=None,
                   help="pixels per traced batch (default: engine heuristic)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render into DIR")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    from .cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from ..core.image import write_png, write_ppm
    from ..models.scenes import SCENE_NAMES, build_scene
    from ..scene.compiler import compile_scene
    from ..utils.config import RenderConfig, reference_samples_for_scene

    spp = args.spp if args.spp is not None else reference_samples_for_scene(args.scene)
    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=spp,
        max_bounces=args.max_bounces, seed=args.seed, engine=args.engine,
        dtype=args.dtype,
    )
    if args.rays_per_batch:
        cfg = cfg.with_(rays_per_batch=args.rays_per_batch)

    dev = jax.devices()[0]
    print(
        f"Rendering scene {args.scene} ({SCENE_NAMES[args.scene]}): "
        f"{cfg.width}x{cfg.height}, {spp} spp, engine={args.engine}, "
        f"backend={dev.platform} ({dev.device_kind})",
        file=sys.stderr,
    )

    desc = build_scene(args.scene)
    dtype = np.float64 if args.dtype == "float64" else np.float32
    scene, meta = compile_scene(desc, cfg.width, cfg.height, dtype=dtype)

    from ..parallel import distributed

    if distributed.initialize():
        print(f"distributed: process {jax.process_index()}/{jax.process_count()}",
              file=sys.stderr)

    prof = None
    if args.profile:
        jax.profiler.start_trace(args.profile)
        prof = args.profile
    t0 = time.perf_counter()
    if args.sharded:
        from ..parallel.render import render_sharded

        img = render_sharded(scene, meta, cfg)
    else:
        from ..ops.render import render

        # quantize on device (byte-identical PPM, 4x less transfer)
        img = jax.block_until_ready(render(scene, meta, cfg, out_u8=True))
    dt = time.perf_counter() - t0
    if prof:
        jax.profiler.stop_trace()
        print(f"profile trace written to {prof}", file=sys.stderr)

    rays = cfg.width * cfg.height * spp
    print(
        f"took {dt:.3f} s  ({rays / dt / 1e6:.2f} M primary rays/s)",  # kernel.cu:693
        file=sys.stderr,
    )
    write_ppm(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    if args.png:
        write_png(args.png, img)
        print(f"wrote {args.png}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
