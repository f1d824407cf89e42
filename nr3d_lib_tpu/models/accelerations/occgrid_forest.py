"""Forest occupancy acceleration: per-block occ grids over a ForestBlockSpace.

Reference: nr3d_lib/models/accelerations/occgrid_accel/forest.py:37
(OccGridAccelForest) + csrc/occ_grid/src/forest_marching.cu:27
(forest_ray_marching). The reference DDA-marches the block octree and each
block's occupancy grid with dynamic step counts; here world rays are marched
at fixed candidate steps and each candidate sample is masked by
(block occupied) ∧ (in-block occupancy cell set) — the static-shape
equivalent of forest marching where empty blocks and empty cells cost a
mask bit instead of a kernel branch. Sample compaction downstream
(pack_ops.dense_to_packed) then drops the masked slots before any network
query, so skipped blocks genuinely skip compute.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.accelerations.occgrid_batched import OccGridEmaBatched

__all__ = ["OccGridAccelForest"]

Array = jax.Array


class OccGridAccelForest(nn.Module):
    """Per-block occupancy grids, block slots shared with the forest space.

    query_fn signature for updates: query_fn(x_world [B,n,3]) → vals [B,n]
    is derived from a world-space val_query_fn via block-local→world mapping.
    """

    def __init__(self, space, *, resolution=(16, 16, 16),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 update_every: int = 16, step_size: Optional[float] = None,
                 max_steps_per_ray: int = 256, **_):
        self.space = space
        n_trees = max(int(space.n_trees), 1)
        self.occ = OccGridEmaBatched(n_trees, resolution, occ_thre, ema_decay)
        self.update_every = int(update_every)
        self.max_steps_per_ray = int(max_steps_per_ray)
        self.step_size = float(step_size if step_size is not None
                               else space.block_size / 16.0)

    # ------------------------------------------------------------- updates
    def _local_to_world(self, x_local: Array, bidx: Array) -> Array:
        """Block-local [-1,1] → world, per block slot."""
        corners = self.space.block_coords[jnp.maximum(bidx, 0)]
        lo = self.space.origin[...] + corners.astype(x_local.dtype) \
            * self.space.block_size
        return lo + (x_local + 1.0) * 0.5 * self.space.block_size

    def init(self, key, val_query_fn: Optional[Callable] = None):
        if val_query_fn is not None:
            self.occ.step_update(key, self._wrap_query(val_query_fn))

    def _wrap_query(self, val_query_fn: Callable) -> Callable:
        def fn(x_local, bidx):
            b, n, _ = x_local.shape
            xw = self._local_to_world(x_local.reshape(b * n, 3),
                                      bidx.reshape(b * n))
            return val_query_fn(xw).reshape(b, n)
        return fn

    def step(self, it: int, key, val_query_fn: Callable):
        if it % self.update_every == 0:
            self.occ.step_update(key, self._wrap_query(val_query_fn))

    def collect_samples(self, x_world: Array, vals: Array):
        bidx = self.space.block_of_points(x_world)
        x_local = self.space.normalize_coords(x_world, bidx)
        self.occ.collect_samples(bidx, x_local, vals)

    # ------------------------------------------------------------- queries
    def query(self, x_world: Array) -> Array:
        """Occupancy bit per world point: block occupied ∧ cell occupied."""
        bidx = self.space.block_of_points(x_world)
        x_local = self.space.normalize_coords(x_world, bidx)
        res = jnp.asarray(self.occ.resolution)
        cell = jnp.floor((x_local + 1.0) * 0.5 * res).astype(jnp.int32)
        inb = jnp.all((cell >= 0) & (cell < res), axis=-1)
        cell = jnp.clip(cell, 0, res - 1)
        occ = self.occ.occ()[jnp.maximum(bidx, 0),
                             cell[..., 0], cell[..., 1], cell[..., 2]]
        return occ & inb & (bidx >= 0)

    def ray_march(self, rays_o: Array, rays_d: Array, near: Array, far: Array,
                  *, n_steps: Optional[int] = None, perturb_key=None
                  ) -> Tuple[Array, Array, Array, Array]:
        """World rays → (t [R,S], dt [R,S], bidx [R,S], mask [R,S]).

        mask applies block occupancy AND per-block cell occupancy —
        the static-shape forest_ray_marching equivalent.
        """
        from nr3d_lib_tpu.ops.occgrid_march import march_steps

        t, dt, in_range = march_steps(near, far,
                                      n_steps or self.max_steps_per_ray,
                                      self.step_size, perturb_key=perturb_key)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        bidx = self.space.block_of_points(x)
        occ = self.query(x)
        return t, dt, bidx, in_range & occ

    def ray_march_segmented(self, rays_o: Array, rays_d: Array,
                            near: Array, far: Array, *,
                            max_segments: int = 32,
                            steps_per_segment: int = 16,
                            perturb_key=None
                            ) -> Tuple[Array, Array, Array, Array]:
        """Segment-based forest marching (reference SPC raytrace →
        forest_ray_marching two-stage, SURVEY §3.5): block segments from the
        space's vectorized raytrace, samples only inside them, then the
        per-block cell-occupancy mask. Unlike `ray_march`, no sample slots
        are spent on inter-block empty space, so the same capacity covers
        much longer rays (large scenes)."""
        segs = self.space.ray_test_segments(rays_o, rays_d, near, far,
                                            max_segments=max_segments)
        t, dt, bidx, mask = self.space.march_segments(
            segs, steps_per_segment=steps_per_segment,
            perturb_key=perturb_key)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        occ = self.query(x)
        return t, dt, bidx, mask & occ

    def debug_stats(self) -> dict:
        occ = self.occ.occ()
        return {"occ_ratio": float(jnp.mean(occ.astype(jnp.float32))),
                "n_occupied": int(jnp.sum(occ))}

    def state_dict(self):
        return {"occ": self.occ.state_dict()}

    def load_state_dict(self, sd):
        self.occ.load_state_dict(sd["occ"])
