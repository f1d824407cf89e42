"""Sharded (multi-host) checkpointing for device-placed pytrees.

`checkpoint.py` is the reference-shaped registry IO (reference:
nr3d_lib/checkpoint.py:19 CheckpointIO): it gathers state to host numpy
and writes one .npz — right for single-host models, wrong for params
sharded over a mesh (a forest's per-block tables or a table-parallel hash
table may exceed one host, and gathering defeats the sharding). This
module is the sharded complement (SURVEY §5 names orbax as the
equivalent): each process writes its own shards via orbax/tensorstore,
and restore places shards directly onto the requested sharding — no
host gather, and resharding on load is free (restore to a different mesh
layout than the save used).

Usage::

    from nr3d_lib_tpu.checkpoint_sharded import (save_sharded, load_sharded,
                                                 abstract_like)
    save_sharded("/ckpts/step_1000", {"blocks": blocks, "mlp": mlp})
    # later — possibly on a different mesh:
    tmpl = {"blocks": abstract_like(blocks2), "mlp": abstract_like(mlp2)}
    state = load_sharded("/ckpts/step_1000", tmpl)
"""

from __future__ import annotations

import os
from typing import Any

import jax

__all__ = ["save_sharded", "load_sharded", "abstract_like"]


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def abstract_like(x) -> Any:
    """ShapeDtypeStruct carrying x's (or the given) sharding — the restore
    template that tells orbax where each shard should land."""
    if isinstance(x, jax.ShapeDtypeStruct):
        return x
    return jax.ShapeDtypeStruct(x.shape, x.dtype,
                                sharding=getattr(x, "sharding", None))


def save_sharded(path: str, tree: Any) -> str:
    """Write a pytree of (possibly sharded) jax.Arrays; blocks until the
    write is durable. Overwrites an existing checkpoint at `path`."""
    path = os.path.abspath(path)
    ckptr = _checkpointer()
    ckptr.save(path, tree, force=True)
    ckptr.wait_until_finished()
    return path


def load_sharded(path: str, template: Any) -> Any:
    """Restore a pytree saved by save_sharded.

    template: pytree of jax.ShapeDtypeStruct (see abstract_like) or live
    arrays — each leaf's sharding says where its shards go; it may differ
    from the sharding used at save time (resharding-on-load).
    """
    path = os.path.abspath(path)
    tmpl = jax.tree_util.tree_map(abstract_like, template)
    return _checkpointer().restore(path, tmpl)
