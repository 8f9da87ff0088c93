"""Where the Pallas kernels run — decided here and nowhere else.

* ``gpu``: compiled through Pallas's Triton route (``backend="triton"``).
* ``cpu``: the Pallas interpreter (the test suite, and the CLI's ``--cpu``).
* anything else: an error naming the platform.  No kernel falls back to
  another engine or to the interpreter on an accelerator.
"""

from __future__ import annotations

import jax

PALLAS_BACKEND = "triton"


def pallas_interpret(platform: str | None = None) -> bool:
    """True when Pallas kernels must run in the interpreter (CPU), False
    when they compile for the card (GPU); raises on any other platform."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: the kernels "
        "compile for NVIDIA GPUs through Triton, or run interpreted on the "
        "CPU")
