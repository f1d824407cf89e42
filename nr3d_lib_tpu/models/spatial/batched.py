"""Batched block space: per-instance AABBs for categorical scenes.

Reference: nr3d_lib/models/spatial/batched.py:20-90 (BatchedBlockSpace) —
B object instances, each with its own AABB; rays/coords carry a batch index
``bidx`` selecting the instance. The reference's `set_condition(bidx)` +
`cur_batch__*` stateful pattern becomes explicit `bidx` arguments (functional,
jit-friendly).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.graphics.raytest import ray_box_intersection

__all__ = ["BatchedBlockSpace", "BatchedDynamicSpace"]

Array = jax.Array


class BatchedBlockSpace(nn.Module):
    """B instance AABBs: ``aabb`` [B, 2, 3]."""

    def __init__(self, aabb=None, *, n_batch: Optional[int] = None, dtype=jnp.float32):
        if aabb is None:
            assert n_batch is not None
            unit = jnp.stack([-jnp.ones(3, dtype), jnp.ones(3, dtype)])
            aabb = jnp.tile(unit[None], (n_batch, 1, 1))
        self.aabb = nn.Variable(jnp.asarray(aabb, dtype))

    @property
    def n_batch(self) -> int:
        return self.aabb[...].shape[0]

    def center(self, bidx: Array) -> Array:
        a = self.aabb[...][bidx]
        return (a[..., 0, :] + a[..., 1, :]) * 0.5

    def radius3d(self, bidx: Array) -> Array:
        a = self.aabb[...][bidx]
        return (a[..., 1, :] - a[..., 0, :]) * 0.5

    def normalize_coords(self, x: Array, bidx: Array) -> Array:
        return (x - self.center(bidx)) / self.radius3d(bidx)

    def unnormalize_coords(self, x: Array, bidx: Array) -> Array:
        return x * self.radius3d(bidx) + self.center(bidx)

    def normalize_rays(self, rays_o: Array, rays_d: Array, bidx: Array
                       ) -> Tuple[Array, Array]:
        return ((rays_o - self.center(bidx)) / self.radius3d(bidx),
                rays_d / self.radius3d(bidx))

    def ray_test(self, rays_o: Array, rays_d: Array, bidx: Array,
                 near: Optional[float] = None, far: Optional[float] = None
                 ) -> Dict[str, Array]:
        a = self.aabb[...][bidx]
        t_near, t_far, hit = ray_box_intersection(
            rays_o, rays_d, a[..., 0, :], a[..., 1, :],
            t_min=near or 0.0, t_max=far or 1e10)
        return {"near": t_near, "far": t_far, "mask": hit, "bidx": bidx,
                "num_rays": rays_o.shape[0], "rays_o": rays_o, "rays_d": rays_d}

    def state_dict(self):
        return {"aabb": self.aabb[...]}

    def load_state_dict(self, sd):
        self.aabb[...] = jnp.asarray(sd["aabb"])


class BatchedDynamicSpace(BatchedBlockSpace):
    """Per-instance AABB + per-instance time range (reference:
    spatial/batched_dynamic.py:22-116 BatchedDynamicSpace /
    BatchedDynamicSpaceNormalizeTs): each instance carries its own
    [ts_start, ts_stop] and normalizes timestamps to [-1, 1] — the space
    for categorical+dynamic scenes (e.g. per-sequence actors)."""

    def __init__(self, aabb=None, *, ts_range=None,
                 n_batch: Optional[int] = None, dtype=jnp.float32):
        super().__init__(aabb, n_batch=n_batch, dtype=dtype)
        if ts_range is None:
            ts_range = jnp.tile(jnp.asarray([[-1.0, 1.0]], dtype),
                                (self.n_batch, 1))
        self.ts_range = nn.Variable(jnp.asarray(ts_range, dtype))

    @staticmethod
    def normalize_all_ts_keyframes(all_ts):
        """Per-instance keyframe lists → (ts_range [B,2], normalized [B,K])
        (reference: batched_dynamic.py:99)."""
        rng = jnp.stack([jnp.min(all_ts, -1), jnp.max(all_ts, -1)], -1)
        mid = (rng[:, 0:1] + rng[:, 1:2]) * 0.5
        half = jnp.maximum((rng[:, 1:2] - rng[:, 0:1]) * 0.5, 1e-8)
        return rng, (all_ts - mid) / half

    def normalize_ts(self, ts: Array, bidx: Array) -> Array:
        r = self.ts_range[...][jnp.maximum(bidx, 0)]
        mid = (r[..., 0] + r[..., 1]) * 0.5
        half = jnp.maximum((r[..., 1] - r[..., 0]) * 0.5, 1e-8)
        return (ts - mid) / half

    def unnormalize_ts(self, ts: Array, bidx: Array) -> Array:
        r = self.ts_range[...][jnp.maximum(bidx, 0)]
        mid = (r[..., 0] + r[..., 1]) * 0.5
        half = (r[..., 1] - r[..., 0]) * 0.5
        return ts * half + mid

    def sample_pts_uniform(self, key, n_per_batch: int
                           ) -> Tuple[Array, Array, Array]:
        """→ (x_normalized [B,n,3], bidx [B,n], ts_normalized [B,n])
        (reference: cur_batch__sample_pts_uniform)."""
        kx, kt = jax.random.split(key)
        b = self.n_batch
        x = jax.random.uniform(kx, (b, n_per_batch, 3), minval=-1.0,
                               maxval=1.0)
        ts = jax.random.uniform(kt, (b, n_per_batch), minval=-1.0,
                                maxval=1.0)
        bidx = jnp.broadcast_to(jnp.arange(b)[:, None], (b, n_per_batch))
        return x, bidx, ts

    def state_dict(self):
        return {"aabb": self.aabb[...], "ts_range": self.ts_range[...]}

    def load_state_dict(self, sd):
        self.aabb[...] = jnp.asarray(sd["aabb"])
        self.ts_range[...] = jnp.asarray(sd["ts_range"])
