"""Ray-marching return structures + wrapper API.

Reference: nr3d_lib/graphics/raymarch/__init__.py:10-60 (RaymarchRet
dataclass family) + occgrid_raymarch.py:25,114,223. The layouts are
dense [R, S] slabs (+ masks) rather than ragged packs; `to_packed()`
compacts when the ragged form is wanted.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from nr3d_lib_tpu.nn import pytree_dataclass
from nr3d_lib_tpu.ops.occgrid_march import (occgrid_march_batched_dense,
                                            occgrid_march_dense)

__all__ = ["RaymarchRetSingle", "RaymarchRetBatched", "RaymarchRetForest",
           "occgrid_raymarch", "occgrid_raymarch_batched"]

Array = jax.Array


@pytree_dataclass
class RaymarchRetSingle:
    """(reference: RaymarchRetSingle) dense [R,S] samples + validity."""

    t: Array
    dt: Array
    mask: Array

    @property
    def num_hit_samples(self) -> Array:
        return jnp.sum(self.mask)

    def positions(self, rays_o: Array, rays_d: Array) -> Array:
        return rays_o[:, None, :] + rays_d[:, None, :] * self.t[..., None]

    def to_packed(self, capacity: Optional[int] = None):
        """→ (t_flat, dt_flat, ridx) compacted packed buffers."""
        from nr3d_lib_tpu.graphics import pack_ops as po

        r, s = self.t.shape
        t_flat, ridx = po.dense_to_packed(self.t, self.mask, capacity)
        dt_flat, _ = po.dense_to_packed(self.dt, self.mask, capacity)
        return t_flat, dt_flat, ridx


@pytree_dataclass
class RaymarchRetBatched(RaymarchRetSingle):
    bidx: Array = None


@pytree_dataclass
class RaymarchRetForest(RaymarchRetSingle):
    block_inds: Array = None


def occgrid_raymarch(occ: Array, rays_o: Array, rays_d: Array, near, far,
                     *, n_steps: int = 256, step_size: float = 0.01,
                     dt_gamma: float = 0.0, max_step_size=None,
                     perturb_key=None) -> RaymarchRetSingle:
    """(reference: occgrid_raymarch occgrid_raymarch.py:25)"""
    t, dt, mask = occgrid_march_dense(
        occ, rays_o, rays_d, jnp.asarray(near), jnp.asarray(far),
        n_steps=n_steps, step_size=step_size, dt_gamma=dt_gamma,
        max_step_size=max_step_size, perturb_key=perturb_key)
    return RaymarchRetSingle(t, dt, mask)


def occgrid_raymarch_batched(occ: Array, bidx: Array, rays_o: Array,
                             rays_d: Array, near, far, *,
                             n_steps: int = 256, step_size: float = 0.01,
                             dt_gamma: float = 0.0, max_step_size=None,
                             perturb_key=None) -> RaymarchRetBatched:
    """(reference: occgrid_raymarch_batched occgrid_raymarch.py:114)"""
    t, dt, mask = occgrid_march_batched_dense(
        occ, bidx, rays_o, rays_d, jnp.asarray(near), jnp.asarray(far),
        n_steps=n_steps, step_size=step_size, dt_gamma=dt_gamma,
        max_step_size=max_step_size, perturb_key=perturb_key)
    return RaymarchRetBatched(t, dt, mask, bidx)
