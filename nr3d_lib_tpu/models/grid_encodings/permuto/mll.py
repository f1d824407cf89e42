"""MLL — multi-level-lattice network (PermutoSDF/neuralgen family).

Reference: nr3d_lib/models/grid_encodings/permuto/mll.py:49
(PermutohedralLatticeLayer), :157 (MLL), :296 (MLLNet). The architecture
chains D *multi-level* permutohedral encodings: layer l's input is layer
l−1's OUTPUT (a feature vector, not a position — this is why the permuto
encoding supports arbitrary input dims), each layer owns an optional
per-layer linear decoder, and non-final layers carry a residual connection
`h = zero·decoded + pad(layer_input)` with a LEARNED scalar `zero`
initialized to 0 (the net starts as an identity chain and learns how much
lattice detail to blend in). MLLNet adds the output head and a
forward-with-nablas path.

Notes: the reference's forward_with_nablas hand-chains each layer's
`backward_dydx` kernel (mll.py:341-410); here one `jax.vjp` through the
stack reaches the same custom VJPs (ops/permuto.py) — the manual chain is
a torch-autograd workaround, not architecture.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.models.blocks import MLP, get_nonlinearity
from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding import (
    PermutoEncoding)

__all__ = ["PermutohedralLatticeLayer", "MLL", "MLLNet"]

Array = jax.Array


def _per_layer(v, d: int, default=None):
    if v is None:
        v = default
    if isinstance(v, (int, float)):
        return [v] * d
    v = list(v)
    assert len(v) == d
    return v


class PermutohedralLatticeLayer(nn.Module):
    """One multi-level lattice + optional decoder + optional residual
    (reference mll.py:49).

    decoder_out_features: None → same as encoding.out_features; -1 → no
    decoder. residual_in_features > 0 enables the learned-zero residual
    (requires residual_in_features ≤ out_features)."""

    def __init__(self, in_features: int, *,
                 decoder_out_features: Optional[int] = None,
                 residual_in_features: int = -1,
                 n_levels: int = 16, n_feats: int = 2,
                 pos_scale: float = 1.0,
                 coarsest_res: float = 10.0, finest_res: float = 1000.0,
                 log2_hashmap_size: int = 18,
                 anneal_cfg: Optional[dict] = None,
                 param_init_std: float = 1e-4, seed: int = 0):
        self.encoding = PermutoEncoding(
            in_features, coarsest_res=coarsest_res, finest_res=finest_res,
            n_levels=n_levels, n_feats=n_feats,
            log2_hashmap_size=log2_hashmap_size, anneal_cfg=anneal_cfg,
            param_init_std=param_init_std, seed=seed)
        self.in_features = in_features
        self.pos_scale = float(pos_scale)
        self.residual_in_features = int(residual_in_features)
        if decoder_out_features is None:
            decoder_out_features = self.encoding.out_features
        if decoder_out_features > 0:
            self.decoder = MLP(self.encoding.out_features,
                               decoder_out_features, D=0, W=16,
                               seed=seed + 1)
            self.out_features = decoder_out_features
        else:
            self.decoder = None
            self.out_features = self.encoding.out_features
        if self.residual_in_features > 0:
            assert self.residual_in_features <= self.out_features, (
                f"out_features={self.out_features} must be >= "
                f"residual_in_features={self.residual_in_features}")
            self.pad_size = self.out_features - self.residual_in_features
            # learned blend scalar, 0 at init (reference mll.py:108 `zero`)
            self.zero = nn.Param(jnp.zeros((), jnp.float32))

    def set_anneal_iter(self, it: int):
        self.encoding.set_anneal_iter(it)

    def _decode(self, h: Array, residual_input: Optional[Array] = None
                ) -> Array:
        if self.decoder is not None:
            h = self.decoder(h)
        if self.residual_in_features > 0:
            assert residual_input is not None and \
                residual_input.shape[-1] == self.residual_in_features
            pad = [(0, 0)] * (residual_input.ndim - 1) + [(0, self.pad_size)]
            h = self.zero[...] * h + jnp.pad(residual_input, pad)
        return h

    def __call__(self, x: Array, residual_input: Optional[Array] = None,
                 max_level: Optional[int] = None) -> Array:
        # PermutoEncoding expects [-1,1]-ish inputs (it remaps ×0.5+0.5);
        # feature-space inputs pass through pos_scale like the reference's
        # lattice pos_scale
        h = self.encoding(x * self.pos_scale, max_level=max_level)
        return self._decode(h, residual_input)

    def stat_param(self, prefix: str = "") -> Dict[str, float]:
        p = self.encoding.flattened_params[...]
        pre = prefix + ("." if prefix and not prefix.endswith(".") else "")
        return {pre + "params.mean": float(p.mean()),
                pre + "params.std": float(p.std()),
                pre + "params.absmax": float(jnp.abs(p).max())}


class MLL(nn.Module):
    """Chained lattice layers (reference mll.py:157): layer l encodes the
    OUTPUT of layer l−1; the last layer has no decoder and no residual."""

    def __init__(self, in_features: int, *, D: int = 2,
                 use_residual: bool = True,
                 lattice_pos_scale: Union[float, Sequence[float]] = 1.0,
                 lattice_n_levels: Union[int, Sequence[int]] = 16,
                 lattice_n_feats: Union[int, Sequence[int]] = 2,
                 lattice_cfg: Optional[dict] = None,
                 decoder_out_feats: Union[None, int, Sequence[int]] = None,
                 seed: int = 0):
        self.in_features = in_features
        self.use_residual = bool(use_residual)
        self.D = int(D)
        n_levels = _per_layer(lattice_n_levels, D)
        n_feats = _per_layer(lattice_n_feats, D)
        pos_scale = _per_layer(lattice_pos_scale, D)
        if isinstance(decoder_out_feats, int):
            decoder_out_feats = [decoder_out_feats] * (D - 1)
        elif decoder_out_feats is not None:
            decoder_out_feats = list(decoder_out_feats)
            assert len(decoder_out_feats) == D - 1

        layers: List[PermutohedralLatticeLayer] = []
        last_out = in_features
        for l in range(D):
            in_dim = in_features if l == 0 else last_out
            if l == D - 1:
                dec_out = -1                     # no decoder at the last layer
                res_in = -1                      # no residual at the last layer
            else:
                dec_out = (None if decoder_out_feats is None
                           else decoder_out_feats[l])
                res_in = in_dim if self.use_residual else -1
            layer = PermutohedralLatticeLayer(
                in_dim, decoder_out_features=dec_out,
                residual_in_features=res_in,
                n_levels=n_levels[l], n_feats=n_feats[l],
                pos_scale=pos_scale[l], **(lattice_cfg or {}),
                seed=seed + 101 * l)
            last_out = layer.out_features
            layers.append(layer)
        self.lattice_layers = nn.List(layers)
        self.last_encoded_features = last_out
        self.out_features = last_out

    def set_anneal_iter(self, it: int):
        for layer in self.lattice_layers:
            layer.set_anneal_iter(it)

    def __call__(self, x: Array, max_level: Optional[int] = None) -> Array:
        h = x
        for layer in self.lattice_layers:
            # for l > 0 the "position" is the previous layer's output; the
            # residual input is the same tensor (reference mll.py:270)
            h = layer(h, h if layer.residual_in_features > 0 else None,
                      max_level=max_level)
        return h

    def get_weight_reg(self, norm_type: float = 2.0) -> Array:
        norms = []
        for layer in self.lattice_layers:
            if layer.decoder is not None:
                for p in jax.tree.leaves(nn.state(layer.decoder, nn.Param)):
                    norms.append(jnp.linalg.norm(p.ravel(), ord=norm_type))
        return jnp.stack(norms) if norms else jnp.zeros((0,))

    def stat_param(self, prefix: str = "") -> Dict[str, float]:
        pre = prefix + ("." if prefix and not prefix.endswith(".") else "")
        out = {}
        for l, layer in enumerate(self.lattice_layers):
            out.update(layer.stat_param(pre + f"lattice_layers.{l}"))
        return out


class MLLNet(MLL):
    """MLL + output head (reference mll.py:296)."""

    def __init__(self, in_features: int, out_features: int, *, D: int = 2,
                 use_residual: bool = False,
                 lattice_n_levels: Union[int, Sequence[int]] = 16,
                 lattice_n_feats: Union[int, Sequence[int]] = 2,
                 decoder_out_feats: Union[None, int, Sequence[int]] = None,
                 lattice_cfg: Optional[dict] = None,
                 output_activation: Optional[str] = None, seed: int = 0):
        super().__init__(in_features, D=D, use_residual=use_residual,
                         lattice_n_levels=lattice_n_levels,
                         lattice_n_feats=lattice_n_feats,
                         decoder_out_feats=decoder_out_feats,
                         lattice_cfg=lattice_cfg, seed=seed)
        self.out_features = out_features
        self.to_output = MLP(self.last_encoded_features, out_features, D=0,
                             W=16, seed=seed + 999)
        self.output_activation = get_nonlinearity(output_activation) \
            or (lambda x: x)

    def __call__(self, x: Array, max_level: Optional[int] = None,
                 return_h: bool = False):
        h = MLL.__call__(self, x, max_level=max_level)
        out = self.output_activation(self.to_output(h))
        return {"output": out, "h": h} if return_h else {"output": out}

    def forward_with_nablas(self, x: Array,
                            max_level: Optional[int] = None,
                            max_pos_dims: Optional[int] = None,
                            max_out_dims: Optional[int] = None) -> Dict:
        """output + d(output[..., :max_out_dims].sum(-1))/dx[..., :max_pos_dims]
        (reference mll.py:341 — there a manual layer-by-layer backward
        chain through each encoding's backward_dydx; here one jax.vjp
        reaches the same custom VJP kernels)."""
        def f(xx):
            r = self.__call__(xx, max_level=max_level, return_h=True)
            return r["output"], r["h"]

        (out, h), vjp = jax.vjp(f, x)
        ones = jnp.ones_like(out)
        if max_out_dims is not None:
            ones = ones * (jnp.arange(out.shape[-1]) < max_out_dims)
        nab = vjp((ones, jnp.zeros_like(h)))[0]
        if max_pos_dims is not None:
            nab = nab[..., :max_pos_dims]
        return {"output": out, "h": h, "nablas": nab}

    def stat_param(self, prefix: str = "") -> Dict[str, float]:
        out = MLL.stat_param(self, prefix)
        pre = prefix + ("." if prefix and not prefix.endswith(".") else "")
        for p in jax.tree.leaves(nn.state(self.to_output, nn.Param)):
            out[pre + "to_output.absmax"] = float(jnp.abs(p).max())
        return out
