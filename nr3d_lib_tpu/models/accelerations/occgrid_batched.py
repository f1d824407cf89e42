"""Batched / dynamic occupancy-grid accelerations.

Reference: nr3d_lib/models/accelerations/occgrid/ema_batched.py:309 +
occgrid_accel/{batched.py:293,batched_dynamic.py:374,dynamic.py:401}.
B instances (or T timestamps) each own a grid; updates are vectorized over
the leading axis.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.accelerations.occgrid import sample_cells_uniform

__all__ = ["OccGridEmaBatched", "OccGridAccelBatched", "OccGridAccelDynamic",
           "OccGridAccelBatchedDynamic", "OccGridAccelStaticAndDynamic"]

Array = jax.Array


class OccGridEmaBatched(nn.Module):
    """[B, r, r, r] EMA value grids (reference: ema_batched.py:309)."""

    def __init__(self, n_batch: int, resolution=(32, 32, 32),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 dtype=jnp.float32):
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.n_batch = int(n_batch)
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.ema_decay = float(ema_decay)
        self.val_grid = nn.Variable(
            jnp.ones((n_batch,) + self.resolution, dtype))

    def occ(self) -> Array:
        return self.val_grid[...] > self.occ_thre

    def collect_samples(self, bidx: Array, x: Array, vals: Array):
        res = jnp.asarray(self.resolution)
        idx = jnp.floor((x + 1.0) * 0.5 * res).astype(jnp.int32)
        inb = jnp.all((idx >= 0) & (idx < res), axis=-1) & (bidx >= 0)
        idx = jnp.clip(idx, 0, res - 1)
        b = jnp.maximum(bidx, 0)
        vals = jnp.where(inb, jnp.abs(vals), -jnp.inf)
        self.val_grid[...] = self.val_grid[...].at[
            b, idx[..., 0], idx[..., 1], idx[..., 2]].max(vals)

    def step_update(self, key, query_fn: Callable[[Array, Array], Array],
                    n_samples: Optional[int] = None):
        """query_fn(x [B,n,3], bidx [B,n]) → vals [B,n]."""
        n_cells = int(np.prod(self.resolution))
        n = n_samples or max(n_cells // 4, 1)
        keys = jax.random.split(key, self.n_batch)
        idxs, xs = jax.vmap(lambda k: sample_cells_uniform(
            k, self.resolution, n, self.val_grid[...].dtype))(keys)
        bidx = jnp.broadcast_to(jnp.arange(self.n_batch)[:, None], (self.n_batch, n))
        fresh = jnp.abs(query_fn(xs, bidx))
        decayed = self.val_grid[...] * self.ema_decay
        b = jnp.broadcast_to(jnp.arange(self.n_batch)[:, None], idxs.shape[:2])
        self.val_grid[...] = decayed.at[
            b, idxs[..., 0], idxs[..., 1], idxs[..., 2]].max(fresh)

    def state_dict(self):
        return {"val_grid": self.val_grid[...]}

    def load_state_dict(self, sd):
        self.val_grid[...] = jnp.asarray(sd["val_grid"])


class OccGridAccelBatched(nn.Module):
    """Per-instance accel (reference: occgrid_accel/batched.py:293
    OccGridAccelBatched_Ema)."""

    def __init__(self, n_batch: int, *, resolution=(32, 32, 32),
                 occ_thre: float = 0.01, ema_decay: float = 0.95,
                 update_every: int = 16, step_size: float = 0.01,
                 max_steps_per_ray: int = 256, **_):
        self.occ = OccGridEmaBatched(n_batch, resolution, occ_thre, ema_decay)
        self.update_every = int(update_every)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)

    def step(self, it: int, key, query_fn):
        if it % self.update_every == 0:
            self.occ.step_update(key, query_fn)

    def collect_samples(self, bidx, x, vals):
        self.occ.collect_samples(bidx, x, vals)

    def ray_march(self, bidx: Array, rays_o: Array, rays_d: Array,
                  near: Array, far: Array, perturb_key=None):
        from nr3d_lib_tpu.graphics.raymarch import occgrid_raymarch_batched

        return occgrid_raymarch_batched(
            self.occ.occ(), bidx, rays_o, rays_d, near, far,
            n_steps=self.max_steps_per_ray, step_size=self.step_size,
            perturb_key=perturb_key)

    def state_dict(self):
        return {"occ": self.occ.state_dict()}

    def load_state_dict(self, sd):
        self.occ.load_state_dict(sd["occ"])


class OccGridAccelDynamic(OccGridAccelBatched):
    """Time-keyed occupancy (reference: occgrid_accel/dynamic.py:401
    OccGridAccelDynamic): one grid per time key, queried by nearest key."""

    def __init__(self, n_time_keys: int, ts_keyframes=None, **kw):
        super().__init__(n_time_keys, **kw)
        ts = jnp.asarray(ts_keyframes if ts_keyframes is not None
                         else jnp.linspace(-1, 1, n_time_keys))
        self.ts_keyframes = nn.Variable(ts)

    def time_to_key(self, ts: Array) -> Array:
        keys = self.ts_keyframes[...]
        return jnp.argmin(jnp.abs(ts[..., None] - keys[None]), axis=-1)

    def ray_march_at_time(self, ts: Array, rays_o, rays_d, near, far,
                          perturb_key=None):
        return self.ray_march(self.time_to_key(ts), rays_o, rays_d, near, far,
                              perturb_key)


class OccGridAccelStaticAndDynamic(nn.Module):
    """Static grid ∪ dynamic time-keyed grids (reference:
    occgrid_accel OccGridAccelStaticAndDynamic)."""

    def __init__(self, n_time_keys: int, *, resolution=(32, 32, 32), **kw):
        from nr3d_lib_tpu.models.accelerations.occgrid import OccGridEma

        self.static = OccGridEma(resolution, **{k: v for k, v in kw.items()
                                                if k in ("occ_thre", "ema_decay")})
        self.dynamic = OccGridAccelDynamic(n_time_keys, resolution=resolution, **kw)

    def occ_at_time(self, key_idx: Array) -> Array:
        return self.static.occ() | self.dynamic.occ.occ()[key_idx]

    def state_dict(self):
        return {"static": self.static.state_dict(),
                "dynamic": self.dynamic.state_dict()}

    def load_state_dict(self, sd):
        self.static.load_state_dict(sd["static"])
        self.dynamic.load_state_dict(sd["dynamic"])


class OccGridAccelBatchedDynamic(nn.Module):
    """Instances × time keys occupancy (reference:
    occgrid_accel/batched_dynamic.py:374 OccGridAccelBatchedDynamic_Ema):
    grid slot (b, k) = instance b at keyframe k; flattened into one
    [B·K, res] EMA-batched grid so updates stay one vectorized pass."""

    def __init__(self, n_batch: int, n_time_keys: int, *,
                 resolution=(32, 32, 32), occ_thre: float = 0.01,
                 ema_decay: float = 0.95, update_every: int = 16,
                 step_size: float = 0.01, max_steps_per_ray: int = 256,
                 ts_keyframes=None, **_):
        self.n_batch = int(n_batch)
        self.n_time_keys = int(n_time_keys)
        self.occ = OccGridEmaBatched(n_batch * n_time_keys, resolution,
                                     occ_thre, ema_decay)
        ts = jnp.asarray(ts_keyframes if ts_keyframes is not None
                         else jnp.linspace(-1, 1, n_time_keys))
        self.ts_keyframes = nn.Variable(ts)
        self.update_every = int(update_every)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)

    def time_to_key(self, ts: Array) -> Array:
        keys = self.ts_keyframes[...]
        return jnp.argmin(jnp.abs(ts[..., None] - keys[None]), axis=-1)

    def slot(self, bidx: Array, ts: Array) -> Array:
        return jnp.maximum(bidx, 0) * self.n_time_keys + self.time_to_key(ts)

    def step(self, it: int, key, query_fn):
        """query_fn(x [B·K, n, 3], bidx [B·K, n], ts [B·K, n]) → vals."""
        if it % self.update_every == 0:
            def fn(x, slot_idx):
                bidx = slot_idx // self.n_time_keys
                ts = self.ts_keyframes[...][slot_idx % self.n_time_keys]
                return query_fn(x, bidx, ts)

            self.occ.step_update(key, fn)

    def collect_samples(self, bidx: Array, ts: Array, x: Array, vals: Array):
        self.occ.collect_samples(self.slot(bidx, ts), x, vals)

    def ray_march(self, bidx: Array, ts: Array, rays_o: Array, rays_d: Array,
                  near: Array, far: Array, perturb_key=None):
        from nr3d_lib_tpu.graphics.raymarch import occgrid_raymarch_batched

        return occgrid_raymarch_batched(
            self.occ.occ(), self.slot(bidx, ts), rays_o, rays_d, near, far,
            n_steps=self.max_steps_per_ray, step_size=self.step_size,
            perturb_key=perturb_key)

    def state_dict(self):
        return {"occ": self.occ.state_dict(),
                "ts_keyframes": self.ts_keyframes[...]}

    def load_state_dict(self, sd):
        self.occ.load_state_dict(sd["occ"])
        self.ts_keyframes[...] = jnp.asarray(sd["ts_keyframes"])
