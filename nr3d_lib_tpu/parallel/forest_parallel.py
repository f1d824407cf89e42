"""Block-sharded forest encoding: scene blocks placed across the mesh.

The reference's large-scale axis is the forest: many blocks sharing one
encoding kernel on ONE GPU (reference: lotd_forest.h, spatial/forest.py).
It never solved multi-device placement (SURVEY §2.3). The mesh-native
scale-out is to give the forest its own mesh axis: per-block parameter
slabs live on the device that owns the block, and a ray's samples are
evaluated by the owning device only.

Key property (same as parallel/table_parallel.py): every sample belongs to
exactly ONE block, so the owning shard computes its contribution and every
other shard contributes exact zeros — one `psum` over the block axis
reconstructs the full feature vector. No ray→block routing, no
`ppermute` of samples, no all_gather of parameters, ever. The bidx<0 →
zero-features convention of the encode (ops/lotd.py:380) makes the mask
free.

Gradients: the psum's vjp broadcasts the cotangent to every shard; the
encode's vjp scatters dL/dparams only onto rows the shard owns (zeros
elsewhere), so per-block parameter gradients stay sharded end to end —
each device updates only its own blocks' parameters (true model
parallelism over scene space).

Compose with a `data` axis for 2D DP×block-MP: rays shard over `data`,
blocks over `block`; the loss psum runs over `data`, the feature psum over
`block`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nr3d_lib_tpu.ops.lotd import LoDMeta, lotd_encode

__all__ = ["pad_blocks_for_sharding", "forest_encode_block_sharded",
           "make_forest_sharded_train_step"]

Array = jax.Array


def pad_blocks_for_sharding(params: Array, n_shards: int) -> Array:
    """Pad the block axis up to a multiple of n_shards (padding blocks are
    never addressed: bidx stays < n_blocks)."""
    nb = params.shape[0]
    target = -(-nb // n_shards) * n_shards
    if target != nb:
        params = jnp.pad(params, ((0, target - nb), (0, 0)))
    return params


def forest_encode_block_sharded(x: Array, bidx: Array, params: Array,
                                meta: LoDMeta, mesh,
                                block_axis: str = "block",
                                data_axis: Optional[str] = None) -> Array:
    """Forest encode with per-block params sharded over `block_axis`.

    Args:
      x: [N, D] block-local coords in [0,1]; sharded over `data_axis` if
        given, else replicated.
      bidx: [N] global block index per sample (−1 → zero features).
      params: [n_blocks, n_params], n_blocks divisible by the block-axis
        size (see pad_blocks_for_sharding); sharded P(block_axis, None).
      meta: static LoDMeta shared by all blocks (reference lotd_forest.py:
        one LoDMeta + per-block param slab).

    Returns [N, n_feats], sharded over `data_axis` like x.
    """
    nb = params.shape[0]
    n_block_shards = mesh.shape[block_axis]
    assert nb % n_block_shards == 0, \
        f"n_blocks {nb} not divisible by block axis {n_block_shards}; " \
        f"use pad_blocks_for_sharding"
    nb_local = nb // n_block_shards
    dspec = P(data_axis) if data_axis else P()
    xspec = P(data_axis, None) if data_axis else P(None, None)

    def local_fn(xl, bl, pl):
        lo = jax.lax.axis_index(block_axis) * nb_local
        owned = (bl >= lo) & (bl < lo + nb_local)
        bl_local = jnp.where(owned, bl - lo, -1)   # −1 → exact zeros
        enc = lotd_encode(xl, pl, meta, bidx=bl_local)
        return jax.lax.psum(enc, block_axis)

    return shard_map(
        local_fn, mesh=mesh,
        in_specs=(xspec, dspec, P(block_axis, None)),
        out_specs=xspec)(x, bidx, params)


def make_forest_sharded_train_step(loss_fn, optimizer, meta: LoDMeta, mesh,
                                   block_axis: str = "block",
                                   data_axis: str = "data"):
    """2D DP×block-MP train step for a forest encoding.

    loss_fn(other_params, feats, batch) -> scalar; it receives the
    block-sharded encode's features so the whole step stays inside one jit.
    `params` pytree: {"blocks": [n_blocks, n_params] (sharded
    P(block_axis)), "other": replicated pytree}. Gradients for "blocks"
    remain sharded (each device updates its own blocks); "other" grads are
    identical on all devices by construction (the data-axis mean is inside
    the loss via psum on replicated compute — XLA partitions it).
    """
    import optax

    def step(params, opt_state, batch, key):
        def full_loss(p):
            feats = forest_encode_block_sharded(
                batch["x"], batch["bidx"], p["blocks"], meta, mesh,
                block_axis=block_axis, data_axis=data_axis)
            return loss_fn(p["other"], feats, batch)

        loss, grads = jax.value_and_grad(full_loss)(params)
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    return jax.jit(step)
