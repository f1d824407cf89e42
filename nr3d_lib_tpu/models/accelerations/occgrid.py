"""Occupancy-grid state: EMA-decayed value grid → binary occupancy.

Reference: nr3d_lib/models/accelerations/occgrid/{ema_single.py:99-229,
getter.py:68-131}. The CUDA version keeps a float value grid updated by EMA
from periodic net queries + samples collected during training, thresholded
into a binary occupancy bitfield consumed by the ray marcher.

Design: the grids are plain module state arrays updated *functionally*
inside jitted update steps; "collect samples" is a scatter-max. No bitfield
packing — XLA bool arrays are cheap and the marcher gathers directly.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

__all__ = ["OccGridEma", "OccGridGetter", "cell_centers", "sample_cells_uniform"]

Array = jax.Array


def cell_centers(resolution: Sequence[int], dtype=jnp.float32) -> Array:
    """Normalized [-1,1]^3 centers of all cells → [prod(res), 3]."""
    lins = [(jnp.arange(r, dtype=dtype) + 0.5) / r * 2.0 - 1.0 for r in resolution]
    grid = jnp.stack(jnp.meshgrid(*lins, indexing="ij"), -1)
    return grid.reshape(-1, len(resolution))


def sample_cells_uniform(key, resolution: Sequence[int], n: int, dtype=jnp.float32
                         ) -> Tuple[Array, Array]:
    """n random cells + a uniform point inside each → (cell_idx [n,3], x [n,3])."""
    res = jnp.asarray(resolution)
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (n, len(resolution)), 0, res)
    u = jax.random.uniform(k2, (n, len(resolution)), dtype)
    x = (idx.astype(dtype) + u) / res.astype(dtype) * 2.0 - 1.0
    return idx, x


class OccGridEma(nn.Module):
    """EMA-decayed value grid thresholded to binary occupancy.

    Mirrors reference behavior (ema_single.py):
      * `init` from constant or from a query function;
      * `collect_samples(x, vals)` — scatter-max training-time queries;
      * `step_update(key, query_fn)` — periodic re-evaluation: all cells are
        EMA-decayed, a random subset (all cells + extra occupied cells in the
        reference; here: n_uniform random cells) is re-queried and max'd in;
      * `occ()` → bool grid; `try_shrink()` → tight AABB of occupancy.
    """

    def __init__(self, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 ema_decay: float = 0.95, n_jump: int = 0,
                 init_cfg: Optional[dict] = None, dtype=jnp.float32):
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.ema_decay = float(ema_decay)
        self.n_jump = int(n_jump)  # warmup iters where everything stays occupied
        init_val = float((init_cfg or {}).get("mode_kwargs", {}).get("constant", 1.0)) \
            if init_cfg else 1.0
        self.val_grid = nn.Variable(jnp.full(self.resolution, init_val, dtype))
        self.it = nn.Variable(jnp.zeros((), jnp.int32))

    # -------------------------------------------------------------- query
    def occ(self) -> Array:
        return self.val_grid[...] > self.occ_thre

    def occupancy_ratio(self) -> Array:
        return jnp.mean(self.occ().astype(jnp.float32))

    def query(self, x: Array) -> Array:
        """Occupancy at normalized positions x ∈ [-1,1]^3."""
        from nr3d_lib_tpu.ops.occgrid_march import occgrid_query

        return occgrid_query(self.occ(), x)

    # ------------------------------------------------------------- updates
    def init_from_net(self, key, query_fn: Callable[[Array], Array],
                      n_steps: int = 4, chunk: int = 2 ** 16):
        """Initialize values from a field query (reference: init from net)."""
        centers = cell_centers(self.resolution, self.val_grid[...].dtype)
        vals = _chunked_query(query_fn, centers, chunk)
        self.val_grid[...] = vals.reshape(self.resolution)

    def collect_samples(self, x: Array, vals: Array):
        """Scatter-max training-time query values into the grid
        (reference: ema_single.py collect_samples)."""
        res = jnp.asarray(self.resolution)
        idx = jnp.floor((x + 1.0) * 0.5 * res).astype(jnp.int32)
        inb = jnp.all((idx >= 0) & (idx < res), axis=-1)
        idx = jnp.clip(idx, 0, res - 1)
        vals = jnp.where(inb, jnp.abs(vals), -jnp.inf)
        self.val_grid[...] = self.val_grid[...].at[
            idx[..., 0], idx[..., 1], idx[..., 2]].max(vals)

    def step_update(self, key, query_fn: Callable[[Array], Array],
                    n_samples: Optional[int] = None):
        """Periodic EMA update (reference: ema_single.py _step_update_occ):
        decay everything, then re-query (a) uniform random cells and
        (b) cells sampled from the current occupancy — the reference queries
        M uniform + M occupied points so live cells never decay away.
        """
        dtype = self.val_grid[...].dtype
        n_cells = int(np.prod(self.resolution))
        n = n_samples or max(n_cells // 4, 1)
        k_uni, k_occ, k_jit = jax.random.split(key, 3)
        idx_u, x_u = sample_cells_uniform(k_uni, self.resolution, n, dtype)
        # occupied-cell resample: categorical over the occupancy mask
        occ_flat = self.occ().reshape(-1)
        logits = jnp.where(occ_flat, 0.0, -jnp.inf)
        any_occ = jnp.any(occ_flat)
        safe_logits = jnp.where(any_occ, logits, jnp.zeros_like(logits))
        flat_idx = jax.random.categorical(k_occ, safe_logits, shape=(n,))
        res = jnp.asarray(self.resolution)
        idx_o = jnp.stack(jnp.unravel_index(flat_idx, self.resolution), -1)
        u = jax.random.uniform(k_jit, (n, 3), dtype)
        x_o = (idx_o.astype(dtype) + u) / res.astype(dtype) * 2.0 - 1.0
        idx = jnp.concatenate([idx_u, idx_o], 0)
        x = jnp.concatenate([x_u, x_o], 0)
        fresh = jnp.abs(query_fn(x)).reshape(-1)
        decayed = self.val_grid[...] * self.ema_decay
        self.val_grid[...] = decayed.at[idx[:, 0], idx[:, 1], idx[:, 2]].max(fresh)
        self.it[...] = self.it[...] + 1

    # -------------------------------------------------------------- shrink
    def try_shrink(self, threshold_ratio: float = 0.0) -> Array:
        """Tight normalized AABB [2,3] of occupied cells (reference try_shrink)."""
        occ = self.occ()
        res = np.asarray(self.resolution)
        out = []
        for d in range(3):
            axes = tuple(i for i in range(3) if i != d)
            any_d = jnp.any(occ, axis=axes)
            idxs = jnp.arange(self.resolution[d])
            lo = jnp.min(jnp.where(any_d, idxs, self.resolution[d]))
            hi = jnp.max(jnp.where(any_d, idxs, -1)) + 1
            out.append((lo.astype(jnp.float32) / res[d] * 2 - 1,
                        hi.astype(jnp.float32) / res[d] * 2 - 1))
        lohi = jnp.asarray(out)  # [3,2]
        return lohi.T  # [2,3] (min,max)

    def state_dict(self):
        return {"val_grid": self.val_grid[...], "it": self.it[...]}

    def load_state_dict(self, sd):
        self.val_grid[...] = jnp.asarray(sd["val_grid"])
        self.it[...] = jnp.asarray(sd["it"])


class OccGridGetter(nn.Module):
    """Direct re-query occupancy without EMA (reference: getter.py:68-131)."""

    def __init__(self, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 dtype=jnp.float32):
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.occ_grid = nn.Variable(jnp.ones(self.resolution, bool))
        self._dtype = dtype

    def occ(self) -> Array:
        return self.occ_grid[...]

    def update(self, query_fn: Callable[[Array], Array], chunk: int = 2 ** 16):
        centers = cell_centers(self.resolution, self._dtype)
        vals = _chunked_query(query_fn, centers, chunk)
        self.occ_grid[...] = (jnp.abs(vals).reshape(self.resolution) > self.occ_thre)

    def state_dict(self):
        return {"occ_grid": self.occ_grid[...]}

    def load_state_dict(self, sd):
        self.occ_grid[...] = jnp.asarray(sd["occ_grid"])


def _chunked_query(query_fn, pts: Array, chunk: int) -> Array:
    n = pts.shape[0]
    if n <= chunk:
        return query_fn(pts).reshape(-1)
    outs = []
    for s in range(0, n, chunk):
        outs.append(query_fn(pts[s:s + chunk]).reshape(-1))
    return jnp.concatenate(outs)
