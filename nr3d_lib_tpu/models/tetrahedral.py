"""DMTet: differentiable marching tetrahedra.

Reference: nr3d_lib/models/tetrahedral/dmtet.py:15 (DMTet mesh extraction
from per-vertex SDF over a deformable tetrahedral grid; splatet.py variant).

Design: static shapes — every tet emits 2 triangle slots with a
validity mask (empty tets → degenerate masked triangles), so extraction
stays inside jit and gradients flow to both SDF values and vertex
positions (the crossing-point lerp is differentiable).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_tet_grid", "marching_tets_jax", "DMTet"]

Array = jax.Array

# standard crack-free 6-tet cube split (shared with csrc/mcubes/mcubes.cpp)
_CUBE_TETS = np.asarray([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int32)

# tet edges in fixed order
_TET_EDGES = np.asarray([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                        np.int32)

# case table: for each 4-bit inside mask → two triangles as edge-index
# triples (−1 padded). Signs handled by orientation fixup at runtime.
_TRI_TABLE = -np.ones((16, 2, 3), np.int32)
for mask in range(1, 15):
    ins = [k for k in range(4) if (mask >> k) & 1]
    outs = [k for k in range(4) if not (mask >> k) & 1]

    def edge_id(a, b):
        a, b = min(a, b), max(a, b)
        return int(np.nonzero((_TET_EDGES == [a, b]).all(-1))[0][0])

    if len(ins) == 1 or len(ins) == 3:
        ref = ins[0] if len(ins) == 1 else outs[0]
        others = [k for k in range(4) if k != ref]
        e = [edge_id(ref, o) for o in others]
        _TRI_TABLE[mask, 0] = e
    else:  # 2-2
        q = [edge_id(ins[0], outs[0]), edge_id(ins[0], outs[1]),
             edge_id(ins[1], outs[1]), edge_id(ins[1], outs[0])]
        _TRI_TABLE[mask, 0] = [q[0], q[1], q[2]]
        _TRI_TABLE[mask, 1] = [q[0], q[2], q[3]]


def make_tet_grid(resolution: int, aabb_min=(-1.0, -1.0, -1.0),
                  aabb_max=(1.0, 1.0, 1.0)) -> Tuple[Array, Array]:
    """Regular tet grid → (verts [Nv,3], tets [Nt,4])."""
    n = resolution
    lin = [np.linspace(aabb_min[d], aabb_max[d], n) for d in range(3)]
    verts = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)

    def vid(x, y, z):
        return (x * n + y) * n + z

    tets = []
    for x in range(n - 1):
        for y in range(n - 1):
            for z in range(n - 1):
                corner_ids = [vid(x + ((c >> 2) & 1), y + ((c >> 1) & 1),
                                  z + (c & 1)) for c in range(8)]
                for t in _CUBE_TETS:
                    tets.append([corner_ids[c] for c in t])
    return (jnp.asarray(verts, jnp.float32), jnp.asarray(tets, jnp.int32))


def marching_tets_jax(verts: Array, sdf: Array, tets: Array
                      ) -> Tuple[Array, Array, Array]:
    """Differentiable marching tets.

    verts [Nv,3] (may include learned deformation), sdf [Nv], tets [Nt,4].
    Returns (tri_verts [Nt,2,3,3], tri_mask [Nt,2]) — fixed-shape triangle
    soup; masked slots are degenerate. Gradients flow into verts and sdf.
    """
    tv = verts[tets]                               # [Nt,4,3]
    ts = sdf[tets]                                 # [Nt,4]
    inside = ts < 0
    mask_bits = (inside[:, 0] * 1 + inside[:, 1] * 2
                 + inside[:, 2] * 4 + inside[:, 3] * 8)

    # crossing point on each of the 6 edges
    ea = jnp.asarray(_TET_EDGES[:, 0])
    eb = jnp.asarray(_TET_EDGES[:, 1])
    va = ts[:, ea]                                 # [Nt,6]
    vb = ts[:, eb]
    denom = va - vb
    t = va / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    t = jnp.clip(t, 0.0, 1.0)[..., None]
    pa = tv[:, ea]                                 # [Nt,6,3]
    pb = tv[:, eb]
    edge_pts = pa + t * (pb - pa)                  # [Nt,6,3]

    table = jnp.asarray(_TRI_TABLE)                # [16,2,3]
    tri_edges = table[mask_bits]                   # [Nt,2,3]
    tri_mask = tri_edges[..., 0] >= 0              # [Nt,2]
    safe = jnp.maximum(tri_edges, 0)
    tri_verts = jnp.take_along_axis(
        edge_pts[:, None].repeat(2, 1), safe[..., None].repeat(3, -1), axis=2)

    # consistent winding: normal away from the tet's inside-centroid
    w_in = inside.astype(verts.dtype)[..., None]
    in_centroid = jnp.sum(tv * w_in, 1) / jnp.maximum(jnp.sum(w_in, 1), 1e-8)
    v0, v1, v2 = tri_verts[:, :, 0], tri_verts[:, :, 1], tri_verts[:, :, 2]
    nrm = jnp.cross(v1 - v0, v2 - v0)
    outward = jnp.sum(nrm * ((v0 + v1 + v2) / 3 - in_centroid[:, None]), -1) >= 0
    flipped = jnp.stack([tri_verts[:, :, 0], tri_verts[:, :, 2],
                         tri_verts[:, :, 1]], 2)
    tri_verts = jnp.where(outward[..., None, None], tri_verts, flipped)
    return tri_verts, tri_mask, mask_bits


class DMTet:
    """Deformable marching-tets extractor (reference: dmtet.py:15 DMTet)."""

    def __init__(self, resolution: int = 32, aabb_min=(-1, -1, -1),
                 aabb_max=(1, 1, 1), max_deform: float = 0.45):
        self.base_verts, self.tets = make_tet_grid(resolution, aabb_min, aabb_max)
        self.cell = float((aabb_max[0] - aabb_min[0]) / (resolution - 1))
        self.max_deform = max_deform

    def __call__(self, sdf: Array, deform: Optional[Array] = None):
        verts = self.base_verts
        if deform is not None:
            verts = verts + jnp.tanh(deform) * (self.max_deform * self.cell)
        return marching_tets_jax(verts, sdf, self.tets)

    def to_mesh(self, tri_verts, tri_mask) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side: compact masked triangle soup → (verts, faces) w/ dedup."""
        tv = np.asarray(tri_verts)[np.asarray(tri_mask)]
        flat = tv.reshape(-1, 3)
        uniq, inv = np.unique(np.round(flat, 6), axis=0, return_inverse=True)
        faces = inv.reshape(-1, 3).astype(np.int32)
        return uniq.astype(np.float32), faces
