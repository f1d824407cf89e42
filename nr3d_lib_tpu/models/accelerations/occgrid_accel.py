"""OccGridAccel — occupancy acceleration wrapper for a single space.

Reference: nr3d_lib/models/accelerations/occgrid_accel/single.py:36-206:
couples an occupancy grid with the space, exposing
init / step / collect_samples / query / ray_march / rescale / try_shrink /
debug_stats to renderer mixins.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.accelerations.occgrid import OccGridEma, OccGridGetter

__all__ = ["OccGridAccel"]

Array = jax.Array


class OccGridAccel(nn.Module):
    def __init__(self, space=None, *, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 ema_decay: float = 0.95, update_every: int = 16,
                 warmup_iters: int = 256, use_ema: bool = True,
                 step_size: float = 0.01, max_steps_per_ray: int = 512,
                 dt_gamma: float = 0.0, max_step_size: Optional[float] = None,
                 **_):
        self.space = space
        if use_ema:
            self.occ = OccGridEma(resolution, occ_thre=occ_thre, ema_decay=ema_decay)
        else:
            self.occ = OccGridGetter(resolution, occ_thre=occ_thre)
        self.use_ema = use_ema
        self.update_every = int(update_every)
        self.warmup_iters = int(warmup_iters)
        self.step_size = float(step_size)
        self.max_steps_per_ray = int(max_steps_per_ray)
        self.dt_gamma = float(dt_gamma)
        self.max_step_size = max_step_size

    # ------------------------------------------------------------ training
    def init(self, key, query_fn: Optional[Callable] = None):
        """Populate-time init (reference single.py init)."""
        if query_fn is not None:
            if self.use_ema:
                self.occ.init_from_net(key, query_fn)
            else:
                self.occ.update(query_fn)

    def step(self, it: int, key, query_fn: Callable):
        """Per-iteration maintenance (reference single.py:84 step): periodic
        EMA re-query / direct update after warmup."""
        if it % self.update_every != 0:
            return
        if self.use_ema:
            self.occ.step_update(key, query_fn)
        else:
            self.occ.update(query_fn)

    def collect_samples(self, x: Array, vals: Array):
        if self.use_ema:
            self.occ.collect_samples(x, vals)

    # ------------------------------------------------------------- queries
    def query(self, x: Array) -> Array:
        from nr3d_lib_tpu.ops.occgrid_march import occgrid_query

        return occgrid_query(self.occ.occ(), x)

    def ray_march(self, rays_o: Array, rays_d: Array, near: Array, far: Array,
                  perturb_key=None, n_steps: Optional[int] = None
                  ) -> Tuple[Array, Array, Array]:
        """March normalized-space rays → dense (t, dt, mask)
        (reference single.py:129 → occgrid_raymarch)."""
        from nr3d_lib_tpu.ops.occgrid_march import occgrid_march_dense

        return occgrid_march_dense(
            self.occ.occ(), rays_o, rays_d, near, far,
            n_steps=n_steps or self.max_steps_per_ray,
            step_size=self.step_size, dt_gamma=self.dt_gamma,
            max_step_size=self.max_step_size, perturb_key=perturb_key)

    # ---------------------------------------------------------------- misc
    def try_shrink(self) -> Optional[Array]:
        if self.use_ema:
            return self.occ.try_shrink()
        return None

    def debug_stats(self) -> dict:
        occ = self.occ.occ()
        return {"occ_ratio": float(jnp.mean(occ.astype(jnp.float32))),
                "n_occupied": int(jnp.sum(occ))}

    def state_dict(self):
        return {"occ": self.occ.state_dict()}

    def load_state_dict(self, sd):
        self.occ.load_state_dict(sd["occ"])
