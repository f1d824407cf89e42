"""Sphere tracing for neural SDFs.

Re-design of the reference's persistent CUDA tracer
(reference: csrc/sphere_trace/ + nr3d_lib/graphics/sphere_trace.py:22-120).
The CUDA version ping-pongs host↔device per iteration with a Python SDF
callback and compacts alive rays to keep occupancy high. Here the whole
trace is ONE `lax.while_loop` with the SDF net inlined; "compaction" is lane
masking — idle lanes cost nothing extra because the batch shape is static
(SURVEY.md §3.4 translation note).

Segment seeding from a dense occupancy grid (reference DenseGrid ray_march)
reuses `ops/occgrid_march`: the first occupied sample along each ray seeds
the trace origin.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["SphereTracer", "sphere_trace", "RayStatus"]

Array = jax.Array


class RayStatus:
    ALIVE = 0
    HIT = 1
    OUT = 2


class SphereTracer:
    """Config holder mirroring the reference class API
    (csrc/sphere_trace/src/entry.cu:14-47 SphereTracer)."""

    def __init__(self, *, distance_scale: float = 1.0,
                 hit_threshold: float = 5e-4,
                 max_march_iters: int = 64,
                 drop_alive_rate: float = 0.0,
                 occ_grid: Optional[Array] = None):
        self.distance_scale = distance_scale
        self.hit_threshold = hit_threshold
        self.max_march_iters = max_march_iters
        self.occ_grid = occ_grid

    def trace(self, rays_o: Array, rays_d: Array, near: Array, far: Array,
              sdf_query: Callable[[Array], Array]) -> Dict[str, Array]:
        return sphere_trace(rays_o, rays_d, near, far, sdf_query,
                            distance_scale=self.distance_scale,
                            hit_threshold=self.hit_threshold,
                            max_iters=self.max_march_iters,
                            occ_grid=self.occ_grid)


def sphere_trace(rays_o: Array, rays_d: Array, near: Array, far: Array,
                 sdf_query: Callable[[Array], Array], *,
                 distance_scale: float = 1.0,
                 hit_threshold: float = 5e-4,
                 max_iters: int = 64,
                 occ_grid: Optional[Array] = None,
                 occ_march_steps: int = 128) -> Dict[str, Array]:
    """Trace rays to the SDF zero crossing.

    rays in the normalized [-1,1]^3 space (dirs unit-norm). Returns
    {t, x, sdf, status, hit} with status ∈ {ALIVE, HIT, OUT}.

    The adaptive step is t += scale·sdf (classic sphere tracing); rays whose
    sdf < hit_threshold are HIT, rays past `far` are OUT. With an occupancy
    grid, the trace starts at the first occupied sample along the ray
    (reference: dense_grid_ray_march seeding, src/ray_march.cu:11-34).
    """
    r = rays_o.shape[0]
    t0 = near
    if occ_grid is not None:
        from nr3d_lib_tpu.ops.occgrid_march import occgrid_march_dense

        tt, dt, mask = occgrid_march_dense(
            occ_grid, rays_o, rays_d, near, far,
            n_steps=occ_march_steps, step_size=float(2.0 / occ_march_steps))
        # first occupied sample per ray (or near if none)
        first = jnp.argmax(mask, axis=-1)
        has = jnp.any(mask, axis=-1)
        t_seed = jnp.take_along_axis(tt, first[:, None], -1)[:, 0]
        # rays with no occupied sample still trace from `near`: a sparse or
        # stale occupancy grid must never turn hits into misses (the grid is
        # a seed accelerator, not an oracle)
        t0 = jnp.where(has, jnp.maximum(t_seed - 2.0 / occ_march_steps, near),
                       near)

    def body(state):
        t, status, it = state
        x = rays_o + rays_d * t[:, None]
        sdf = sdf_query(x).reshape(r) * distance_scale
        alive = status == RayStatus.ALIVE
        # signed stepping: overshoots walk back to the crossing; rays pinned
        # at `near` with sdf<0 started inside the surface → immediate hit
        hit = alive & ((jnp.abs(sdf) < hit_threshold)
                       | ((sdf < 0) & (t <= t0 + 1e-9)))
        step = jnp.maximum(jnp.abs(sdf), hit_threshold * 0.5) * jnp.sign(sdf)
        t_new = jnp.where(alive & ~hit, jnp.maximum(t + step, t0), t)
        out = alive & (t_new > far)
        status = jnp.where(hit, RayStatus.HIT,
                           jnp.where(out, RayStatus.OUT, status))
        return t_new, status, it + 1

    def cond(state):
        t, status, it = state
        return (it < max_iters) & jnp.any(status == RayStatus.ALIVE)

    status0 = jnp.where(near < far, RayStatus.ALIVE, RayStatus.OUT)
    t, status, _ = jax.lax.while_loop(
        cond, body, (t0, status0.astype(jnp.int32), jnp.asarray(0)))
    # The traced depth is a sample-placement result, not a differentiable
    # quantity (reverse-mode through while_loop is undefined anyway);
    # downstream NeuS queries volume-render AT these positions, and the
    # final sdf_query below still carries parameter gradients.
    t = jax.lax.stop_gradient(t)
    x = rays_o + rays_d * t[:, None]
    sdf = sdf_query(x).reshape(r)
    return {"t": t, "x": x, "sdf": sdf, "status": status,
            "hit": status == RayStatus.HIT}
