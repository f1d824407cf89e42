"""SDF field nets: LoTD-encoded and MLP (geometric init) variants.

Reference: nr3d_lib/models/fields/sdf/{lotd_sdf.py:201-258,mlp_sdf.py,
utils.py}. The signature `forward_sdf_nablas` double-backward trick
(SURVEY.md §3.2) is realized with `jax.vjp` — differentiating through the
returned nablas drives JAX's higher-order autodiff instead of the
reference's hand-written 2nd-order CUDA kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP
from nr3d_lib_tpu.models.embedders import get_embedder
from nr3d_lib_tpu.models.grid_encodings.lotd import LoTDEncoding

__all__ = ["LoTDSDF", "MlpSDF", "pretrain_sdf_sphere"]

Array = jax.Array


class LoTDSDF(nn.Module):
    """LoTD encoding + small decoder → (sdf, geometry feature)
    (reference: lotd_sdf.py LoTDSDF)."""

    def __init__(self, *, encoding_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15,
                 bounding_radius: float = 1.0,
                 seed: int = 0):
        from nr3d_lib_tpu.models.grid_encodings.lotd import get_lotd_encoding

        enc_cfg = dict(encoding_cfg or {})
        enc_cfg.setdefault("lotd_cfg", {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 15})
        self.encoding = get_lotd_encoding(3, **enc_cfg, seed=seed)
        dec_cfg = dict(decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        dec_cfg.setdefault("activation", "relu")
        self.decoder = MLP(self.encoding.out_features + 3, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1)
        self.n_geo_feat = n_geo_feat
        self.bounding_radius = bounding_radius

    def _sdf_h(self, x: Array) -> Array:
        """x in [-1,1] → [.., 1+n_geo_feat]; decoder also sees raw x so the
        net can express a global sphere-ish prior."""
        h = self.encoding(x)
        return self.decoder(jnp.concatenate([x, h], -1))

    def forward_sdf(self, x: Array) -> Dict[str, Array]:
        out = self._sdf_h(x)
        return {"sdf": out[..., 0], "h": out[..., 1:]}

    def forward_sdf_nablas(self, x: Array, has_grad: bool = True
                           ) -> Dict[str, Array]:
        """(sdf, h, nablas=∂sdf/∂x) — reference lotd_sdf.py:201
        forward_sdf_nablas. Gradients through `nablas` (eikonal loss)
        trigger second-order autodiff end-to-end."""

        def f(xx):
            out = self._sdf_h(xx)
            return out[..., 0], out[..., 1:]

        (sdf, h), vjp_fn = jax.vjp(f, x)
        nablas = vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]
        return {"sdf": sdf, "h": h, "nablas": nablas}

    def __call__(self, x: Array) -> Array:
        return self.forward_sdf(x)["sdf"]


class PermutoSDF(nn.Module):
    """Static permutohedral-encoded SDF (reference: fields/sdf/
    permuto_sdf.py PermutoSDF): permuto lattice features + small decoder,
    optional sphere geometric-init residual."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 n_geo_feat: int = 15, radius_init: float = 0.0,
                 seed: int = 0):
        from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding \
            import PermutoParams

        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 17)
        self.bank = PermutoParams(
            3, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed)
        self.meta = self.bank.meta
        dec_cfg = dict(decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features + 3, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1)
        self.n_geo_feat = n_geo_feat
        self.radius_init = float(radius_init)

    def _sdf_h(self, x: Array) -> Array:
        h = self.bank.encode(x * 0.5 + 0.5)
        out = self.decoder(jnp.concatenate([x, h], -1))
        if self.radius_init > 0:
            out = out.at[..., 0].add(jnp.linalg.norm(x, axis=-1)
                                     - self.radius_init)
        return out

    forward_sdf = LoTDSDF.forward_sdf
    forward_sdf_nablas = LoTDSDF.forward_sdf_nablas

    def __call__(self, x: Array) -> Array:
        return self._sdf_h(x)[..., 0]


class MlpSDF(nn.Module):
    """Geometric-init MLP SDF (reference: mlp_sdf.py): freq-embedded input,
    skip connection, softplus(β=100), sphere init."""

    def __init__(self, *, pos_embed_cfg: Optional[dict] = None,
                 D: int = 8, W: int = 256, skips=(4,),
                 n_geo_feat: int = 15, radius_init: float = 0.5, seed: int = 0):
        self.embed_fn, pos_dim = get_embedder(
            pos_embed_cfg or {"type": "identity"}, 3)
        self.mlp = MLP(pos_dim, 1 + n_geo_feat, D=D, W=W, skips=skips,
                       activation="softplus", geometric_init=True,
                       radius_init=radius_init, seed=seed)
        self.n_geo_feat = n_geo_feat

    def _sdf_h(self, x: Array) -> Array:
        return self.mlp(self.embed_fn(x))

    forward_sdf = LoTDSDF.forward_sdf
    forward_sdf_nablas = LoTDSDF.forward_sdf_nablas

    def __call__(self, x: Array) -> Array:
        return self._sdf_h(x)[..., 0]


def pretrain_sdf_sphere(model, key, *, radius: float = 0.5, n_iters: int = 500,
                        n_pts: int = 2048, lr: float = 1e-3) -> float:
    """Fit the SDF to a sphere before scene training
    (reference: fields/sdf/utils.py pretrain_sdf_sphere). Returns final loss."""
    import optax

    opt = optax.adam(lr)
    graphdef, params, rest = nn.split(model, nn.Param, ...)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        x = jax.random.uniform(key, (n_pts, 3), minval=-1.0, maxval=1.0)
        target = jnp.linalg.norm(x, axis=-1) - radius

        def loss_fn(p):
            m = nn.merge(graphdef, p, rest)
            return jnp.mean((m(x) - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    loss = jnp.inf
    for i in range(n_iters):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
    nn.update(model, params)
    return float(loss)
