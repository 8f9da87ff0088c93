"""Real multi-host execution path: a 2-process `jax.distributed` cluster.

The reference is single-process (SURVEY.md §2: no NCCL/MPI, `kernel.cu:570-742`);
this framework runs multi-host SPMD.  Every other mesh
test runs single-process on 8 virtual devices; this one actually spawns two
OS processes (4 virtual CPU devices each), stitches them with
`parallel.distributed.initialize` (coordinator on localhost), builds the
8-device GLOBAL mesh, and renders through the same `render_sharded` program.

Pass criterion: the distributed image is BIT-IDENTICAL to the
single-process single-device render at sp=1 — the determinism contract
(counter RNG keyed on global pixel/sample ids) extended across process
boundaries.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "distributed_child.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render_bit_identical(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    out = str(tmp_path / "dist_img.npy")

    env = dict(os.environ)
    # the child sets its own XLA_FLAGS device count; drop the suite's 8-dev
    # flag so it does not accumulate
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, coordinator, "2", str(i), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=900)
            outputs.append(stdout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed children timed out:\n"
                    + "\n".join(outputs))
    for i, p in enumerate(procs):
        assert p.returncode == 0, (
            f"child {i} failed (rc={p.returncode}):\n{outputs[i]}")
    assert os.path.exists(out), "primary never wrote the image"

    dist_img = np.load(out)

    # single-process reference: the SAME render_sharded program on this
    # pytest process's 8 virtual devices, same (px=8, sp=1) mesh shape —
    # the distributed cluster must be indistinguishable from it
    import jax

    from raytracinginoneweekendincuda_tpu.models import scenes
    from raytracinginoneweekendincuda_tpu.parallel.render import (
        make_mesh, render_sharded,
    )
    from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
    from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

    W, H, spp = 64, 48, 4
    scene, meta = compile_scene(scenes.build_scene(4), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       engine="mega2")
    mesh = make_mesh(jax.devices()[:8], sample_shards=1)
    ref = np.asarray(render_sharded(scene, meta, cfg, mesh), np.float32)

    assert dist_img.shape == ref.shape
    assert np.array_equal(dist_img, ref), (
        f"distributed render differs: max abs diff "
        f"{np.abs(dist_img - ref).max()}")
