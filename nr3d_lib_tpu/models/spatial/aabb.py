"""AABB space: coordinate normalization + ray test.

Reference: nr3d_lib/models/spatial/aabb.py:21-139 (AABBSpace) and
aabb_dynamic.py:21-41 (AABBDynamicSpace). The space maps world coordinates
into the canonical [-1, 1]^3 cube used by encodings, performs the slab ray
test, and supports volume rescaling (shrink) during training.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.graphics.raytest import ray_box_intersection

__all__ = ["AABBSpace", "AABBDynamicSpace"]

Array = jax.Array


class AABBSpace(nn.Module):
    """Axis-aligned box space.

    State: ``aabb`` [2, 3] (min, max) — mutable to support `rescale_volume`
    (reference aabb.py:120 shrink support).
    """

    def __init__(self, aabb=None, *, center=None, radius=None, dtype=jnp.float32):
        if aabb is None:
            center = jnp.zeros(3, dtype) if center is None else jnp.asarray(center, dtype)
            radius = jnp.ones(3, dtype) * (1.0 if radius is None else jnp.asarray(radius, dtype))
            aabb = jnp.stack([center - radius, center + radius])
        self.aabb = nn.Variable(jnp.asarray(aabb, dtype))

    @property
    def center(self) -> Array:
        return (self.aabb[...][0] + self.aabb[...][1]) * 0.5

    @property
    def radius3d(self) -> Array:
        return (self.aabb[...][1] - self.aabb[...][0]) * 0.5

    @property
    def scale(self) -> Array:
        return self.radius3d

    # ------------------------------------------------------------- coords
    def normalize_coords(self, x: Array) -> Array:
        """World → [-1, 1] (reference aabb.py normalize_coords)."""
        return (x - self.center) / self.radius3d

    def unnormalize_coords(self, x: Array) -> Array:
        return x * self.radius3d + self.center

    def normalize_rays(self, rays_o: Array, rays_d: Array) -> Tuple[Array, Array]:
        """World rays → normalized-space rays (dir NOT re-normalized so t is
        shared between spaces; reference aabb.py normalize_rays)."""
        return (rays_o - self.center) / self.radius3d, rays_d / self.radius3d

    # ------------------------------------------------------------ ray test
    def ray_test(self, rays_o: Array, rays_d: Array,
                 near: Optional[float] = None, far: Optional[float] = None,
                 return_rays: bool = True) -> Dict[str, Array]:
        """Slab test against the box (reference aabb.py:85).

        Static shapes: instead of boolean-indexing hit rays (dynamic shape), we
        return full-size arrays plus a hit mask; downstream marching treats
        missed rays as empty packs.
        """
        t_near, t_far, hit = ray_box_intersection(
            rays_o, rays_d, self.aabb[...][0], self.aabb[...][1],
            t_min=near or 0.0, t_max=far or 1e10)
        ret = {"near": t_near, "far": t_far, "mask": hit,
               "num_rays": rays_o.shape[0]}
        if return_rays:
            ret["rays_o"] = rays_o
            ret["rays_d"] = rays_d
        return ret

    # ------------------------------------------------------------- rescale
    def rescale_volume(self, new_aabb: Array):
        """Shrink/expand the box (reference aabb.py rescale_volume)."""
        self.aabb[...] = jnp.asarray(new_aabb, self.aabb[...].dtype)

    # --------------------------------------------------------------- misc
    def sample_pts_uniform(self, n_pts: int, key) -> Array:
        u = jax.random.uniform(key, (n_pts, 3), self.aabb[...].dtype)
        return self.aabb[...][0] + u * (self.aabb[...][1] - self.aabb[...][0])

    def state_dict(self):
        return {"aabb": self.aabb[...]}

    def load_state_dict(self, sd):
        self.aabb[...] = jnp.asarray(sd["aabb"])


class AABBDynamicSpace(AABBSpace):
    """AABB space + time normalization (reference aabb_dynamic.py:21-41)."""

    def __init__(self, aabb=None, ts_keyframes=None, *, dtype=jnp.float32, **kw):
        super().__init__(aabb, dtype=dtype, **kw)
        ts = jnp.asarray(ts_keyframes if ts_keyframes is not None else [0.0, 1.0], dtype)
        self.ts_keyframes = nn.Variable(ts)

    def normalize_ts(self, ts: Array) -> Array:
        """Time → [-1, 1] over the keyframe span (reference normalize_ts)."""
        t0 = self.ts_keyframes[...][0]
        t1 = self.ts_keyframes[...][-1]
        return (ts - t0) / jnp.maximum(t1 - t0, 1e-8) * 2.0 - 1.0

    def unnormalize_ts(self, ts: Array) -> Array:
        t0 = self.ts_keyframes[...][0]
        t1 = self.ts_keyframes[...][-1]
        return (ts + 1.0) * 0.5 * (t1 - t0) + t0

    def state_dict(self):
        return {"aabb": self.aabb[...], "ts_keyframes": self.ts_keyframes[...]}

    def load_state_dict(self, sd):
        self.aabb[...] = jnp.asarray(sd["aabb"])
        self.ts_keyframes[...] = jnp.asarray(sd["ts_keyframes"])
