"""Engine dispatch: route a ray batch to the configured tracing engine.

``engine`` selects between the brute-force closest-hit engine (optimal for
the reference's scene sizes, `ops/hit.py`) and the flattened-BVH engine
(`ops/bvh_engine.py`, the reference's BvhNode acceleration re-designed for
batched arrays).  Both produce identical images for identical RNG streams — the
reference's own strongest test (MD5-identical output with/without BVH,
`Docs/2권_3장_BVH_CUDA적용판.md:733`) is reproduced in tests/test_bvh.py.
"""

from __future__ import annotations

from .integrator import trace


def trace_dispatch(
    scene, meta, o, d, time, pix_ctr, sample, *,
    engine: str = "bruteforce",
    max_bounces: int,
    t_min: float,
    differentiable: bool = False,
    bvh=None,
):
    if engine == "bvh":
        from .bvh_engine import trace_bvh

        if bvh is None:
            raise ValueError("engine='bvh' needs BVH arrays (scene/bvh.py)")
        return trace_bvh(
            scene, meta, bvh, o, d, time, pix_ctr, sample,
            max_bounces=max_bounces, t_min=t_min, differentiable=differentiable,
        )
    if engine != "bruteforce":
        raise ValueError(f"unknown engine {engine!r}")
    return trace(
        scene, meta, o, d, time, pix_ctr, sample,
        max_bounces=max_bounces, t_min=t_min, differentiable=differentiable,
    )
