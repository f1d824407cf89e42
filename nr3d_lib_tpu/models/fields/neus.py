"""NeuS field: SDF net + radiance net + inv_s variance control.

Reference: nr3d_lib/models/fields/neus/{lotd_neus.py:35-123,variance.py:20-143}.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.annealers import get_annealer
from nr3d_lib_tpu.models.fields.nerf import RadianceNet
from nr3d_lib_tpu.models.fields.sdf import LoTDSDF, MlpSDF

__all__ = ["LearnedVar", "ScheduledVar", "get_neus_var_ctrl", "LoTDNeuS",
           "PermutoNeuS", "MlpNeuS"]

Array = jax.Array


class LearnedVar(nn.Module):
    """Single learnable inv_s = exp(10·ln_s) (reference: variance.py
    get_neus_var_ctrl 'learned'; original NeuS parameterization)."""

    def __init__(self, init_val: float = 0.3):
        self.ln_s = nn.Param(jnp.asarray(np.log(init_val) / 10.0, jnp.float32))

    def inv_s(self) -> Array:
        return jnp.exp(self.ln_s[...] * 10.0)

    def set_iter(self, it: int):
        pass

    def state_dict(self):
        return {"ln_s": self.ln_s[...]}

    def load_state_dict(self, sd):
        self.ln_s[...] = jnp.asarray(sd["ln_s"])


class ScheduledVar(nn.Module):
    """inv_s follows an annealer schedule (reference: variance.py 'scheduled'
    / 'manual')."""

    def __init__(self, **anneal_cfg):
        self.annealer = get_annealer(**anneal_cfg)
        self.cur = nn.Variable(jnp.asarray(float(self.annealer(0)), jnp.float32))

    def inv_s(self) -> Array:
        return self.cur[...]

    def set_iter(self, it: int):
        self.cur[...] = jnp.asarray(float(self.annealer(it)), jnp.float32)

    def state_dict(self):
        return {"cur": self.cur[...]}

    def load_state_dict(self, sd):
        self.cur[...] = jnp.asarray(sd["cur"])


def get_neus_var_ctrl(type: str = "learned", **kwargs):
    t = type.lower()
    if t in ("learned", "single"):
        return LearnedVar(**kwargs)
    if t in ("scheduled", "manual"):
        return ScheduledVar(**kwargs)
    raise ValueError(f"Unknown var ctrl: {type}")


class _NeuSBase(nn.Module):
    def forward_sdf(self, x: Array) -> Dict[str, Array]:
        return self.implicit_surface.forward_sdf(x)

    def forward_sdf_nablas(self, x: Array) -> Dict[str, Array]:
        return self.implicit_surface.forward_sdf_nablas(x)

    def forward_inv_s(self) -> Array:
        return self.var_ctrl.inv_s()

    def __call__(self, x: Array, v: Optional[Array] = None,
                 with_rgb: bool = True, with_nablas: bool = True
                 ) -> Dict[str, Array]:
        """(sdf, nablas, rgb) joint forward (reference: lotd_neus.py:141)."""
        if with_nablas or with_rgb:
            out = self.forward_sdf_nablas(x)
        else:
            out = self.forward_sdf(x)
        if with_rgb:
            out["rgb"] = self.radiance(x, v, out.get("nablas"), out["h"])
        return out


class LoTDNeuS(_NeuSBase):
    """LoTD-encoded NeuS (reference: lotd_neus.py:35 LoTDNeuS)."""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = LoTDSDF(**(surface_cfg or {}), seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat,
            use_nablas=True, use_pos=True,
            **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))


class PermutoNeuS(_NeuSBase):
    """Permuto-encoded NeuS (reference: fields/neus/permuto_neus.py
    PermutoNeuS — the PermutoSDF paper's configuration)."""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        from nr3d_lib_tpu.models.fields.sdf import PermutoSDF

        self.implicit_surface = PermutoSDF(**(surface_cfg or {}), seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat,
            use_nablas=True, use_pos=True,
            **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))


class MlpNeuS(_NeuSBase):
    """Geometric-init MLP NeuS (reference: mlp_neus.py)."""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0):
        self.implicit_surface = MlpSDF(**(surface_cfg or {}), seed=seed)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat,
            use_nablas=True, use_pos=True,
            **(radiance_cfg or {}), seed=seed + 1)
        self.var_ctrl = get_neus_var_ctrl(**(var_ctrl_cfg or {"type": "learned"}))
