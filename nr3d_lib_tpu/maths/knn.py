"""KNN + chamfer distance.

Reference: externals/pytorch3d_knn (N9: knn_points/knn_gather,
maths/pytorch3d_knn.py:130,216), externals/simple_knn (N10: distCUDA2 —
mean 3-NN distance for 3DGS init), maths/chamfer_distance.py:8.

Design: brute-force distance matrices in tiles — as matmuls this is
`x·yᵀ` plus norms, which beats clever spatial structures for the sizes the
reference targets (≤ ~1e5 points) and is fully differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["knn_points", "knn_gather", "chamfer_distance", "dist_to_nn3_mean"]

Array = jax.Array


def _sq_dists(x: Array, y: Array) -> Array:
    """[N,D]×[M,D] → [N,M] squared distances via one matmul."""
    xx = jnp.sum(x * x, -1, keepdims=True)
    yy = jnp.sum(y * y, -1, keepdims=True)
    xy = x @ y.T
    return jnp.maximum(xx - 2 * xy + yy.T, 0.0)


def knn_points(x: Array, y: Array, k: int = 1, chunk: int = 8192,
               candidate_margin: Optional[int] = None
               ) -> Tuple[Array, Array]:
    """For each x, the K nearest in y → (sq_dists [N,K], idx [N,K]).

    Batched ([B,N,D]) or flat ([N,D]). Reference: knn_points_idx.

    Selection is approximate-then-exact: the matmul expansion picks
    `k + candidate_margin` candidates, exact coordinate-difference
    distances rank them. The expansion's f32 cancellation error scales
    with ‖x‖·‖y‖, so both clouds are shifted by a shared centroid first
    (distance-preserving) to keep coordinate magnitudes small; the margin
    (default `max(4, k)`) then covers near-tie misrankings. Raise
    `candidate_margin` for pathologically dense near-tie clouds.
    """
    if x.ndim == 3:
        return jax.vmap(
            lambda a, b: knn_points(a, b, k, chunk, candidate_margin))(x, y)
    n, m = x.shape[0], y.shape[0]
    # Shared centroid shift: cancellation in ‖x‖²−2x·y+‖y‖² grows with
    # ‖x‖·‖y‖ (ADVICE r2) — centering makes the error ~scene-extent-scaled
    # rather than offset-scaled. The same shift applies to both clouds so
    # all pairwise distances are unchanged.
    c = (jnp.mean(x, axis=0) + jnp.mean(y, axis=0)) * 0.5
    xs = x - c
    ys = y - c
    # The centered expansion still loses ~1e-6·extent² to cancellation, so
    # it only SELECTS candidates (with a k-scaled safety margin); the
    # returned distances are recomputed from coordinate differences of the
    # ORIGINAL (uncentered) points — centering itself rounds each f32
    # coordinate by ~‖c‖·2⁻²⁴, which would perturb the refined distances.
    kc = min(k + (candidate_margin if candidate_margin is not None
                  else max(4, k)), m)
    outs_d, outs_i = [], []
    for s in range(0, n, chunk):
        xc = x[s:s + chunk]
        d = _sq_dists(xs[s:s + chunk], ys)
        _, cand = jax.lax.top_k(-d, kc)
        d_exact = jnp.sum((xc[:, None, :] - y[cand]) ** 2, -1)
        neg_top, sel = jax.lax.top_k(-d_exact, k)
        outs_d.append(-neg_top)
        outs_i.append(jnp.take_along_axis(cand, sel, axis=-1))
    return jnp.concatenate(outs_d), jnp.concatenate(outs_i)


def knn_gather(y: Array, idx: Array) -> Array:
    """Gather neighbor features (reference knn_gather): y [M,D], idx [N,K]."""
    if y.ndim == 3:
        return jax.vmap(knn_gather)(y, idx)
    return y[idx]


def chamfer_distance(x: Array, y: Array, *, squared: bool = True
                     ) -> Tuple[Array, Array]:
    """Bidirectional chamfer (reference chamfer_distance.py:8):
    returns (mean_x→y, mean_y→x)."""
    dx, _ = knn_points(x, y, 1)
    dy, _ = knn_points(y, x, 1)
    dx = dx[..., 0]
    dy = dy[..., 0]
    if not squared:
        dx = jnp.sqrt(jnp.maximum(dx, 1e-12))
        dy = jnp.sqrt(jnp.maximum(dy, 1e-12))
    return jnp.mean(dx), jnp.mean(dy)


def dist_to_nn3_mean(pts: Array) -> Array:
    """Mean squared distance to the 3 nearest neighbors — the 3DGS scale
    initializer (reference: simple_knn distCUDA2)."""
    d, _ = knn_points(pts, pts, 4)  # first neighbor is self (d=0)
    return jnp.mean(d[:, 1:4], axis=-1)
