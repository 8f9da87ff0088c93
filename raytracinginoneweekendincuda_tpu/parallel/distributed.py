"""Multi-host bootstrap.

The reference is single-process/single-GPU (SURVEY.md §2: no NCCL/MPI, no
peer copies).  This framework scales SPMD: the same `shard_map` programs
(`parallel/render.py`, `parallel/train.py`) run unchanged across hosts once
`jax.distributed.initialize` has stitched them into one runtime.  This
module is the thin, idempotent entry point for that.

Typical multi-host launch (same command on every host):

    python -m raytracinginoneweekendincuda_tpu.utils.cli --scene 9 --sharded

with the environment (`JAX_COORDINATOR_ADDRESS` etc.) set by the launcher,
or explicit arguments via `initialize()`.
"""

from __future__ import annotations

import jax

_INITIALIZED = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Idempotent `jax.distributed.initialize` wrapper.

    No-ops (returns False) in single-process settings: no coordinator
    address given as an argument or in the environment.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    import os

    have_env = bool(
        coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if not have_env:
        return False
    kw = {}
    if coordinator_address:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)
    _INITIALIZED = True
    return True


def global_mesh(sample_shards: int | None = None):
    """Mesh over every device in the (possibly multi-host) runtime."""
    from .render import make_mesh

    return make_mesh(jax.devices(), sample_shards=sample_shards)


def is_primary() -> bool:
    """True on the process that should write output files."""
    return jax.process_index() == 0
