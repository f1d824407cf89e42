"""Multi-host / multi-chip parallelism utilities.

Replacement for the reference's NCCL/DDP plumbing
(reference: nr3d_lib/distributed.py:20-139). Instead of process groups we
expose ONE device mesh and rely on `jax.sharding` + `shard_map`/`pjit` to
emit the collectives (NCCL over NVLink on GPUs). Axes convention (SURVEY.md §2.3/§7):

  * ``data``  — rays / pixels / batch elements (DP; gradients psum'd)
  * ``block`` — scene blocks (forest / batched-categorical sharding)

`init_env()` initializes `jax.distributed` when launched multi-host and
seeds per-process RNG; `make_mesh()` builds the mesh used everywhere.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "init_env",
    "set_seed",
    "rank",
    "local_rank",
    "world_size",
    "is_master",
    "make_mesh",
    "get_mesh",
    "data_parallel_spec",
    "replicated_spec",
]

_STATE = {"initialized": False, "seed": 42}


def rank() -> int:
    import jax

    return jax.process_index()


def local_rank() -> int:
    return rank()


def world_size() -> int:
    import jax

    return jax.process_count()


def is_master() -> bool:
    try:
        return rank() == 0
    except Exception:
        return True


def init_env(seed: int = 42,
             coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX + seed RNG.

    Single-process runs need no initialization; multi-host runs (detected via
    the standard JAX coordinator env vars or explicit arguments) call
    `jax.distributed.initialize`. This replaces the reference's
    torchrun/SLURM/Aliyun NCCL launcher adapters
    (reference: nr3d_lib/distributed.py:37-120) — JAX handles launcher
    detection (SLURM/OpenMPI/GKE) natively inside `distributed.initialize`.
    """
    if _STATE["initialized"]:
        return
    import jax

    want_dist = (
        coordinator_address is not None
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if want_dist:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    set_seed(seed)
    _STATE["initialized"] = True


def set_seed(seed: int) -> None:
    """Record the global seed (reference: nr3d_lib/distributed.py set_seed).

    JAX RNG is explicit (`jax.random.key`); this seeds numpy + python for
    host-side sampling and stores the base seed for `base_key()`.
    """
    import random

    _STATE["seed"] = seed
    np.random.seed(seed)
    random.seed(seed)


def base_key():
    import jax

    return jax.random.key(_STATE["seed"])


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data", "block"),
              devices=None):
    """Create the global device mesh.

    With no arguments: all devices along ``data``, ``block``=1.
    """
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    assert int(np.prod(axis_sizes)) == n, (
        f"mesh axes {axis_sizes} != {n} devices")
    dev_array = np.asarray(devices).reshape(axis_sizes)
    mesh = Mesh(dev_array, axis_names)
    _STATE["mesh"] = mesh
    return mesh


def get_mesh():
    if "mesh" not in _STATE:
        return make_mesh()
    return _STATE["mesh"]


def data_parallel_spec():
    from jax.sharding import PartitionSpec as P

    return P("data")


def replicated_spec():
    from jax.sharding import PartitionSpec as P

    return P()
