"""Golden-hash regression over all ten reference scenes.

The determinism contract (counter RNG keyed on global ids, fixed seed
1984 — kernel.cu:105,118) makes whole-image hashing nearly free, and it
is the reference's own strongest verification method: the BVH change was
validated by MD5-hashing output.ppm (Docs/2권_3장_BVH_CUDA적용판.md:733).
These tests pin the quantized uint8 output of BOTH the XLA engine and the
mega2 megakernel (Pallas interpreter on this CPU suite) at a small config
per scene, so any future engine change that silently shifts an image
fails loudly here; an INTENDED image change must update the table below
(regenerate with the block at the bottom).

Hashes are CPU-backend values (the suite's conftest pins JAX_PLATFORMS=
cpu).  On most scenes the two engines are bit-identical; scene 0 differs
on f32 winner ties of the key-space sphere test and scene 3 on Perlin
rounding — estimator-class deviations, which is exactly why each engine
pins its own hash.
"""

import hashlib

import numpy as np
import pytest

from raytracinginoneweekendincuda_tpu.models import scenes
from raytracinginoneweekendincuda_tpu.ops.render import render
from raytracinginoneweekendincuda_tpu.scene.compiler import compile_scene
from raytracinginoneweekendincuda_tpu.utils.config import RenderConfig

# sid -> (xla_bruteforce_hash, mega2_hash); sha256 prefix of the u8 frame
GOLDEN = {
    0: ("12b1d28e331add0d", "fa0b5fea756e71dd"),
    1: ("b672c0e0deed792d", "b672c0e0deed792d"),
    2: ("a01075de72c1ee23", "a01075de72c1ee23"),
    3: ("34f59d8a0a656af1", "379f5a01abc81449"),
    4: ("b9c0d1e4e0b1c580", "b9c0d1e4e0b1c580"),
    5: ("3ed2750bd16c342c", "3ed2750bd16c342c"),
    6: ("cab2eaa0bd9266e0", "cab2eaa0bd9266e0"),
    7: ("927c2b2cca2abb30", "927c2b2cca2abb30"),
    8: ("f9c9e6aa360c0da4", "f9c9e6aa360c0da4"),
    9: ("59223d04eb0e228a", "59223d04eb0e228a"),
}


def _frame_hash(sid: int, engine: str) -> str:
    W, H = (16, 8) if sid == 9 else (24, 12)
    scene, meta = compile_scene(scenes.build_scene(sid), W, H,
                                dtype=np.float32)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2,
                       max_bounces=8, engine=engine)
    img = render(scene, meta, cfg, out_u8=True)
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
        .hexdigest()[:16]


@pytest.mark.parametrize("sid", range(10))
def test_golden_xla(sid):
    assert _frame_hash(sid, "bruteforce") == GOLDEN[sid][0]


@pytest.mark.parametrize("sid", range(10))
def test_golden_mega2(sid):
    assert _frame_hash(sid, "mega2") == GOLDEN[sid][1]


if __name__ == "__main__":          # regenerate the GOLDEN table
    for sid in range(10):
        print(f'    {sid}: ("{_frame_hash(sid, "bruteforce")}", '
              f'"{_frame_hash(sid, "mega2")}"),')
