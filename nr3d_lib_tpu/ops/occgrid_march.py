"""Occupancy-grid ray marching (functional core).

Re-design of the reference's nerfacc-derived CUDA marcher
(reference: csrc/occ_grid/src/{ray_marching.cu:17-100,batched_marching.cu,
forest_marching.cu}; API csrc/occ_grid/src/occ_grid.cpp:23-32). The CUDA
version walks a DDA per ray in two rounds (count, then fill) producing
ragged packed samples with `dt_gamma` geometric step growth.

Here the step sequence is *closed-form* (geometric-growth steps are
a cumsum of a static-length dt vector), so candidate samples form a dense
[R, S_max] grid computed entirely vectorized; occupancy lookup masks out
candidates in empty voxels. Masked results either stay dense (for fixed-count
pipelines) or are compacted into packed buffers (for the ragged pipeline) —
compaction replaces the CUDA two-round count/fill scheme.

Marching happens in the normalized [-1,1]^3 space of the grid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["march_steps", "occgrid_query", "occgrid_march_dense",
           "occgrid_march_batched_dense"]

Array = jax.Array


def march_steps(near: Array, far: Array, n_steps: int, step_size: float,
                dt_gamma: float = 0.0, max_step_size: Optional[float] = None,
                perturb_key: Optional[Array] = None
                ) -> Tuple[Array, Array, Array]:
    """Closed-form step sequence per ray.

    Returns (t_start [R,S], dt [R,S], in_range [R,S]) with
    dt_i = clip(step_size·(1+γ)^i, ·, max_step_size), t cumulative from near
    (reference: ray_marching.cu calc_dt / dt_gamma semantics).
    """
    r = near.shape[0]
    i = jnp.arange(n_steps, dtype=near.dtype)
    if dt_gamma > 0.0:
        dt = step_size * jnp.power(1.0 + dt_gamma, i)
        if max_step_size is not None:
            dt = jnp.minimum(dt, max_step_size)
    else:
        dt = jnp.full((n_steps,), step_size, near.dtype)
    t_end = jnp.cumsum(dt)
    t_start = (t_end - dt)[None, :] + near[:, None]          # [R,S]
    dt = jnp.broadcast_to(dt[None, :], (r, n_steps))
    if perturb_key is not None:
        u = jax.random.uniform(perturb_key, (r, n_steps), near.dtype)
    else:
        u = 0.5
    t_jitter = t_start + u * dt
    in_range = (t_jitter < far[:, None]) & (t_start >= near[:, None] - 1e-9)
    return t_jitter, dt, in_range


def occgrid_query_axes(occ: Array, x0: Array, x1: Array, x2: Array
                       ) -> Array:
    """Per-axis form of `occgrid_query`: x0/x1/x2 are SAME-SHAPE arrays of
    normalized coordinates (the marcher builds them per axis and never
    stacks a [..., 3] array)."""
    shp = occ.shape
    idxs, inb = [], None
    for xi, ri in zip((x0, x1, x2), shp):
        u = (xi + 1.0) * 0.5
        ii = jnp.floor(u * jnp.asarray(ri, xi.dtype)).astype(jnp.int32)
        ok = (ii >= 0) & (ii < ri)
        inb = ok if inb is None else (inb & ok)
        idxs.append(jnp.clip(ii, 0, ri - 1))
    i0, i1, i2 = idxs
    flat = (i0 * shp[1] + i1) * shp[2] + i2
    vals = jnp.take(occ.reshape(-1), flat, mode="clip")
    return vals & inb


def occgrid_query(occ: Array, x: Array) -> Array:
    """Query a binary occupancy grid at normalized positions x ∈ [-1,1]^D.

    occ: [r0, r1, r2] bool. Out-of-range queries return False. Lookups are
    one flat `take`; hot paths with coordinates already separated call
    `occgrid_query_axes`.
    """
    return occgrid_query_axes(occ, x[..., 0], x[..., 1], x[..., 2])


def occgrid_march_dense(occ: Array, rays_o: Array, rays_d: Array,
                        near: Array, far: Array, *,
                        n_steps: int, step_size: float,
                        dt_gamma: float = 0.0,
                        max_step_size: Optional[float] = None,
                        perturb_key: Optional[Array] = None
                        ) -> Tuple[Array, Array, Array]:
    """March rays through an occupancy grid → dense [R, S] samples + mask.

    Rays must already be in the grid's normalized [-1,1]^3 space
    (use `AABBSpace.normalize_rays`). Returns (t [R,S], dt [R,S], mask [R,S])
    where mask = in-range ∧ voxel-occupied — the dense equivalent of the
    reference's packed (t_starts, t_ends, ridx) triple.
    """
    t, dt, in_range = march_steps(near, far, n_steps, step_size, dt_gamma,
                                  max_step_size, perturb_key)
    # per-axis [R,S] coordinates (see occgrid_query_axes)
    xs = [rays_o[:, None, a] + rays_d[:, None, a] * t for a in range(3)]
    occ_hit = occgrid_query_axes(occ, *xs)
    return t, dt, in_range & occ_hit


def occgrid_march_batched_dense(occ: Array, bidx: Array,
                                rays_o: Array, rays_d: Array,
                                near: Array, far: Array, *,
                                n_steps: int, step_size: float,
                                dt_gamma: float = 0.0,
                                max_step_size: Optional[float] = None,
                                perturb_key: Optional[Array] = None
                                ) -> Tuple[Array, Array, Array]:
    """Batched variant: occ [B, r, r, r], bidx [R] selects each ray's grid
    (reference: batched_ray_marching, csrc/occ_grid/src/batched_marching.cu:18)."""
    t, dt, in_range = march_steps(near, far, n_steps, step_size, dt_gamma,
                                  max_step_size, perturb_key)
    shp = occ.shape[1:]
    idxs, inb = [], None
    for a, ri in enumerate(shp):
        xa = rays_o[:, None, a] + rays_d[:, None, a] * t      # [R,S]
        ii = jnp.floor((xa + 1.0) * 0.5 * ri).astype(jnp.int32)
        ok = (ii >= 0) & (ii < ri)
        inb = ok if inb is None else (inb & ok)
        idxs.append(jnp.clip(ii, 0, ri - 1))
    b = jnp.maximum(bidx, 0)[:, None]
    row = (b * shp[0] + idxs[0]) * shp[1] + idxs[1]
    vals = jnp.take(occ.reshape(-1), row * shp[2] + idxs[2], mode="clip")
    occ_hit = vals & inb & (bidx >= 0)[:, None]
    return t, dt, in_range & occ_hit
