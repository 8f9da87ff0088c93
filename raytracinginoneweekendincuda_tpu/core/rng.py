"""Counter-based RNG for the path tracer.

The CUDA reference keeps one mutable cuRAND XORWOW state per pixel
(`kernel.cu:101-119`, seed 1984, subsequence = pixelIndex) and threads it
through every sampler.  Mutable per-thread state is the wrong shape for
XLA/Pallas: everything under `jit` is traced functionally, and a sharded
renderer must produce bit-identical streams regardless of how pixels are
split across chips.

We therefore use a *counter-based* generator: every uniform draw is a pure
hash of the tuple ``(seed ^ pixel, sample, stream | bounce, slot)``.  This is
the design the reference's own roadmap asks for ("Fast RNG: hash-based
PCG/XORShift", README.md:26) and it reproduces the reference's determinism
contract (seeded, per-pixel independent streams) without any state.

The hash is **pcg4d** (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020): a 4-lane 32-bit LCG step followed by a mixing round.  It passes
the usual statistical batteries and is 4-wide, which matches our draw budget
(most consumers need <= 4 uniforms).

Portability contract
--------------------
Every function here is written against plain array ops (``*``, ``+``, ``^``,
``>>``) on uint32 arrays so that the *same code* runs under

* ``numpy`` (the f64 oracle in ``tests/oracle.py``),
* ``jax.numpy`` (the batched engine),
* the Pallas megakernel (uint32 ops lower directly).

NumPy scalars warn on uint32 overflow; arrays wrap silently — callers must
pass arrays (0-d is fine).

Draw-slot layout (shared by oracle and engine)
----------------------------------------------
Streams (the third counter word) namespace the consumers so draw counts can
never collide between subsystems:

==================  =======================  ==========================
stream word         draws (4 per hash call)  consumer
==================  =======================  ==========================
CAMERA_STREAM       jitter_u, jitter_v,      `Camera::GetRay` equivalent
                    lens_u1, lens_u2         (Camera.h:76-85)
CAMERA_STREAM + 1   time_u                   shutter time (Camera.h:80)
SCATTER_STREAM | b  u1, u2, u3 (unit ball),  material scatter at bounce b
                    u4 (dielectric draw)     (Material.h / Dielectric.h:41)
MEDIUM_STREAM | b   one (0,1] draw per       ConstantMedium log-distance
  (slot = medium)   medium index             (ConstantMedium.h:79)
==================  =======================  ==========================
"""

from __future__ import annotations

CAMERA_STREAM = 0x0CA30000
SCATTER_STREAM = 0x5CA70000
MEDIUM_STREAM = 0x3ED00000

_INV_2POW24 = 1.0 / 16777216.0  # draws use the top 24 bits -> exact in f32


def pcg4d(v0, v1, v2, v3):
    """4-lane counter hash: four uint32 arrays in, four uint32 arrays out.

    All four outputs are independent uniform 32-bit words for distinct
    inputs.  Inputs must already be uint32 arrays of a common shape.
    """
    v0 = v0 * 1664525 + 1013904223
    v1 = v1 * 1664525 + 1013904223
    v2 = v2 * 1664525 + 1013904223
    v3 = v3 * 1664525 + 1013904223

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


def _to_unit_float(word, float_dtype):
    """uint32 word -> float in [0, 1) using the top 24 bits (f32-exact)."""
    import numpy as _np

    scale = _np.dtype(float_dtype).type(_INV_2POW24)
    return (word >> 8).astype(float_dtype) * scale


def uniform4(pixel, sample, stream, slot, *, float_dtype):
    """Four independent uniforms in [0, 1) for one counter tuple.

    ``pixel`` should already have the global seed folded in (``seed ^ pix``).
    Arguments are uint32 arrays of a common (broadcastable) shape.
    """
    w0, w1, w2, w3 = pcg4d(pixel, sample, stream, slot)
    return (
        _to_unit_float(w0, float_dtype),
        _to_unit_float(w1, float_dtype),
        _to_unit_float(w2, float_dtype),
        _to_unit_float(w3, float_dtype),
    )


def uniform_open4(pixel, sample, stream, slot, *, float_dtype):
    """Four uniforms in (0, 1] — curand_uniform's range (kernel.cu comment at
    ConstantMedium.h:26: "(0,1] so log(0) can't happen")."""
    import numpy as _np

    w0, w1, w2, w3 = pcg4d(pixel, sample, stream, slot)
    one = _np.dtype(float_dtype).type(_INV_2POW24)
    return (
        _to_unit_float(w0, float_dtype) + one,
        _to_unit_float(w1, float_dtype) + one,
        _to_unit_float(w2, float_dtype) + one,
        _to_unit_float(w3, float_dtype) + one,
    )
