"""Error-map-driven importance pixel sampling.

Reference: nr3d_lib/models/importance.py — `ErrorMap` (per-frame error
accumulation + NGP-style CDF construction, construct_cdf:121) and
`ImpSampler` (2D inverse-CDF pixel sampling, sample_pixel:302).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

__all__ = ["ErrorMap", "ImpSampler"]

Array = jax.Array


class ErrorMap(nn.Module):
    """Per-frame low-res error accumulation grid [n_frames, eh, ew]."""

    def __init__(self, n_frames: int, res: Tuple[int, int] = (128, 128),
                 ema: float = 0.9, dtype=jnp.float32):
        self.res = tuple(res)
        self.ema = float(ema)
        self.error_map = nn.Variable(
            jnp.ones((n_frames,) + self.res, dtype))

    def collect(self, frame_idx: Array, xy: Array, errors: Array):
        """Scatter EMA of per-ray errors into the map.

        xy: [N,2] normalized pixel coords in [0,1] (x right, y down).
        """
        eh, ew = self.res
        ix = jnp.clip((xy[:, 0] * ew).astype(jnp.int32), 0, ew - 1)
        iy = jnp.clip((xy[:, 1] * eh).astype(jnp.int32), 0, eh - 1)
        fi = jnp.broadcast_to(jnp.asarray(frame_idx), ix.shape)
        cur = self.error_map[...]
        old = cur[fi, iy, ix]
        new = self.ema * old + (1.0 - self.ema) * errors
        self.error_map[...] = cur.at[fi, iy, ix].set(new)

    def construct_cdf(self) -> Tuple[Array, Array]:
        """Row/pixel CDFs per frame (reference construct_cdf:121)."""
        em = self.error_map[...] + 1e-8
        row_sum = jnp.sum(em, axis=-1)                        # [F, eh]
        cdf_rows = jnp.cumsum(row_sum, -1)
        cdf_rows = cdf_rows / cdf_rows[..., -1:]
        cdf_cols = jnp.cumsum(em, -1)
        cdf_cols = cdf_cols / cdf_cols[..., -1:]
        return cdf_rows, cdf_cols

    def state_dict(self):
        return {"error_map": self.error_map[...]}

    def load_state_dict(self, sd):
        self.error_map[...] = jnp.asarray(sd["error_map"])


class ImpSampler(nn.Module):
    """Inverse-CDF 2D pixel sampler with uniform mixing
    (reference ImpSampler.sample_pixel:302; frac_uniform keeps exploration)."""

    def __init__(self, error_map: ErrorMap, frac_uniform: float = 0.5):
        self.error_map = error_map
        self.frac_uniform = float(frac_uniform)

    def sample_pixel(self, key, n: int, frame_idx: int) -> Array:
        """→ xy [n, 2] in [0,1]²."""
        k1, k2, k3, k4 = jax.random.split(key, 4)
        cdf_rows, cdf_cols = self.error_map.construct_cdf()
        eh, ew = self.error_map.res
        u_row = jax.random.uniform(k1, (n,))
        iy = jnp.searchsorted(cdf_rows[frame_idx], u_row)
        iy = jnp.clip(iy, 0, eh - 1)
        u_col = jax.random.uniform(k2, (n,))
        icol_cdf = cdf_cols[frame_idx][iy]                     # [n, ew]
        ix = jax.vmap(jnp.searchsorted)(icol_cdf, u_col)
        ix = jnp.clip(ix, 0, ew - 1)
        jitter = jax.random.uniform(k3, (n, 2))
        xy_imp = jnp.stack([(ix + jitter[:, 0]) / ew,
                            (iy + jitter[:, 1]) / eh], -1)
        xy_uni = jax.random.uniform(k4, (n, 2))
        take_uni = (jnp.arange(n) < int(n * self.frac_uniform))
        return jnp.where(take_uni[:, None], xy_uni, xy_imp)
