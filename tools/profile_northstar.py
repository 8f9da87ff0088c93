"""Capture a jax.profiler trace of the north-star config (or any scene)
and print a per-op device-time attribution from the trace events.

Usage: python tools/profile_northstar.py [spp] [outdir]
"""
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from raytracinginoneweekendincuda_tpu.models.scenes import book1_final
from raytracinginoneweekendincuda_tpu.ops.mega2 import render_mega2
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

W, H = 1200, 675
SPP = int(sys.argv[1]) if len(sys.argv) > 1 else 100
OUT = sys.argv[2] if len(sys.argv) > 2 else "/tmp/ns_profile"

import jax

print(f"backend: {jax.devices()}", file=sys.stderr)
cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP)
scene, meta = compile_scene(book1_final(), W, H, dtype=np.float32)

t0 = time.perf_counter()
img = render_mega2(scene, meta, cfg, out_u8=True)
print(f"compile+first: {time.perf_counter()-t0:.1f} s", file=sys.stderr)

with jax.profiler.trace(OUT):
    t0 = time.perf_counter()
    img = render_mega2(scene, meta, cfg, out_u8=True)
    wall = time.perf_counter() - t0
assert img.any()
print(f"frame: {wall:.3f} s = {W*H*SPP/wall/1e6:.2f} M rays/s")

# ---- parse the trace: sum device-lane event durations by op name
paths = glob.glob(os.path.join(OUT, "**", "*.trace.json.gz"), recursive=True)
assert paths, f"no trace under {OUT}"
with gzip.open(sorted(paths)[-1], "rt") as f:
    tr = json.load(f)
events = tr["traceEvents"]
# device pids (GPU process names / device lanes)
pid_name = {}
tid_name = {}
for e in events:
    if e.get("ph") == "M" and e.get("name") == "process_name":
        pid_name[e["pid"]] = e["args"].get("name", "")
    if e.get("ph") == "M" and e.get("name") == "thread_name":
        tid_name[(e["pid"], e["tid"])] = e["args"].get("name", "")
dev_pids = {p for p, n in pid_name.items()
            if "GPU" in n or "gpu" in n or "Device" in n}
bucket = defaultdict(float)
total = 0.0
for e in events:
    if e.get("ph") != "X" or e["pid"] not in dev_pids:
        continue
    tname = tid_name.get((e["pid"], e["tid"]), "")
    if "step" in tname.lower():
        continue
    dur = e.get("dur", 0) / 1e6
    bucket[e["name"]] += dur
    total += dur
print(f"\ndevice event time total: {total:.3f} s  (wall {wall:.3f} s)")
for name, dur in sorted(bucket.items(), key=lambda kv: -kv[1])[:25]:
    print(f"  {dur*1000:9.1f} ms  {100*dur/max(total,1e-9):5.1f}%  {name[:110]}")
