"""Headline benchmark: scene 0 (bouncing spheres) at the reference's own
measured config — 1440x720, 10 spp (`Docs/2권_3장_BVH_CUDA적용판.md:733`:
0.47 s with BVH on an RTX 5070 Ti ≈ 22 M primary rays/s, see BASELINE.md).

Runs in this process on the GPU and refuses to run without one.  Prints the
card's name and power limit on an earlier line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# scene 0 with BVH on an RTX 5070 Ti, build configuration unstated by the
# reference (BASELINE.md)
BASELINE_RAYS_PER_S = 22.0e6


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """The first JAX device, which must be a GPU (raises otherwise)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} "
                         f"({dev.device_kind}); nothing is measured")
    return dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--width", type=int, default=1440)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--engine", default="mega2")
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)

    import jax

    dev = require_gpu()
    from .cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from ..models.scenes import build_scene
    from ..ops.render import render
    from ..scene.compiler import compile_scene
    from .config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, engine=args.engine)
    scene, meta = compile_scene(build_scene(args.scene), cfg.width,
                                cfg.height, dtype=np.float32)
    print(f"bench: card {card_line()}; jax {dev.platform} "
          f"({dev.device_kind}); scene {args.scene} "
          f"{cfg.width}x{cfg.height} @ {args.spp} spp, engine={args.engine}",
          file=sys.stderr)

    # Timed region ends at device completion, the reference's clock()
    # boundary (kernel.cu:675-693 stops BEFORE the framebuffer readback);
    # mega2 keeps the frame on device, the other engines return host arrays
    dev_out = args.engine == "mega2"

    def run():
        return jax.block_until_ready(
            render(scene, meta, cfg, out_u8=True, device_out=dev_out))

    t0 = time.perf_counter()
    run()
    setup = time.perf_counter() - t0
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        img = run()
        best = min(best, time.perf_counter() - t0)
    img = np.asarray(img)
    assert img.size == cfg.height * cfg.width * 3 and img.any()
    rays_per_s = cfg.width * cfg.height * args.spp / best
    print(f"bench: compile + first run {setup:.3f} s; best of "
          f"{args.repeats}: {best:.4f} s", file=sys.stderr)
    print(json.dumps({
        "metric": f"primary rays/s, scene {args.scene} "
                  f"{cfg.width}x{cfg.height}@{args.spp}spp ({args.engine})",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
