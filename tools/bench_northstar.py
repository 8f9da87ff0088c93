"""North-star benchmark (BASELINE.json): Book-1 final scene, 1200x675,
500 spp, one GPU.  Prints the card, then rays/s.

Usage: python tools/bench_northstar.py [spp] [repeats]
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from raytracinginoneweekendincuda_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

from raytracinginoneweekendincuda_tpu.models.scenes import book1_final
from raytracinginoneweekendincuda_tpu.ops.mega2 import render_mega2
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

W, H = 1200, 675
SPP = int(sys.argv[1]) if len(sys.argv) > 1 else 500
REP = int(sys.argv[2]) if len(sys.argv) > 2 else 2

from raytracinginoneweekendincuda_tpu.utils.benchmark import (
    card_line, require_gpu,
)

require_gpu()
print(f"card: {card_line()}", file=sys.stderr)
cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP)
scene, meta = compile_scene(book1_final(), W, H, dtype=np.float32)

t0 = time.perf_counter()
img = render_mega2(scene, meta, cfg, out_u8=True)
print(f"compile+first: {time.perf_counter()-t0:.1f} s", file=sys.stderr)
best = float("inf")
for _ in range(REP):
    t0 = time.perf_counter()
    img = render_mega2(scene, meta, cfg, out_u8=True)
    best = min(best, time.perf_counter() - t0)
assert img.any()

rays = W * H * SPP
print(f"book1_final {W}x{H}@{SPP}spp: best {best:.2f} s = "
      f"{rays/best/1e6:.2f} M primary rays/s")
