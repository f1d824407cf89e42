"""Forest block space: large-scale scenes as a grid of occupied blocks.

Re-design of the reference's kaolin-SPC-octree forest
(reference: nr3d_lib/models/spatial/forest.py:162-396 ForestBlockSpace +
csrc/forest N6 ForestMeta). The reference stores occupied blocks in an
octree and raytraces it with kaolin SPC; here the block set is a dense
coarse boolean grid — at practical forest sizes (≤128³ blocks) a dense grid
is smaller than the octree's pointers, ray testing reuses the DDA-free
occupancy marcher, and everything stays static-shape / XLA-friendly.

Blocks are cubes of side `block_size` anchored at `origin`; occupied blocks
get dense slots [0, n_trees) via `block_idx` (−1 = empty). Per-block LoTD
parameters use the slot as the batched-encode `bidx`
(SURVEY.md §3.5 translation).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from nr3d_lib_tpu import nn

from nr3d_lib_tpu.graphics.raytest import ray_box_intersection

__all__ = ["ForestBlockSpace"]

Array = jax.Array


def _topk_by_key(key: Array, payloads, k: int):
    """k smallest-key entries per row with their payloads, via one
    lax.sort (not argsort + take_along_axis)."""
    sorted_ = jax.lax.sort((key, *payloads), num_keys=1, is_stable=True)
    return tuple(p[:, :k] for p in sorted_[1:])


class ForestBlockSpace(nn.Module):
    def __init__(self, *, level: int = 4, origin=(-1.0, -1.0, -1.0),
                 block_size: float = 0.5, resolution: Optional[Sequence[int]] = None,
                 dtype=jnp.float32):
        """resolution: blocks per axis (default 2^level as in the reference's
        octree level)."""
        if resolution is None:
            resolution = (2 ** level,) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.level = level
        self.origin = nn.Variable(jnp.asarray(origin, dtype))
        self.block_size = float(block_size)
        self.occupied = nn.Variable(jnp.zeros(self.resolution, bool))
        # dense slot per occupied block; -1 for empty (rebuilt on populate)
        self.block_idx = nn.Variable(-jnp.ones(self.resolution, jnp.int32))
        self.n_trees = 0

    # ------------------------------------------------------------ populate
    def _rebuild_slots(self):
        occ = np.asarray(self.occupied[...])
        idx = -np.ones(self.resolution, np.int32)
        coords = np.argwhere(occ)
        idx[tuple(coords.T)] = np.arange(len(coords), dtype=np.int32)
        self.block_idx[...] = jnp.asarray(idx)
        self.n_trees = int(len(coords))
        self._block_coords = jnp.asarray(coords, jnp.int32)  # [n_trees, 3]
        self._build_hierarchy()

    def _build_hierarchy(self, factor: int = 4, max_top: int = 4096):
        """N-level culling structure over the occupied blocks — the
        stand-in for the reference's SPC octree levels (reference
        spatial/forest.py:305-396 + kaolin raytrace): supercells of
        `factor`³ children per level, stacked until the coarsest level has
        ≤ `max_top` cells. Ray tests dense-test the coarsest level, then
        descend — expand the K nearest hits' children, slab-test, keep K —
        making `ray_test_segments` O(S_top + T·K·factor³) per ray instead of
        O(n_trees): the SPC octree descent as T static-shape passes, no
        pointer chasing. A single super level reproduces the round-2
        two-level structure."""
        self._hier_factor = int(factor)
        coords = np.asarray(self._block_coords)
        self._hier_coords = []   # level i ≥ 1 cell coords [S_i, 3]
        self._hier_members = []  # level i cell → level i−1 children [S_i,f³]
        if len(coords) == 0:
            self._super_coords = jnp.zeros((0, 3), jnp.int32)
            self._super_members = jnp.zeros((0, factor ** 3), jnp.int32)
            return
        cur = coords
        while True:
            sc = cur // factor                                    # [C,3]
            uniq, inv = np.unique(sc, axis=0, return_inverse=True)
            members = -np.ones((len(uniq), factor ** 3), np.int32)
            fill = np.zeros(len(uniq), np.int64)
            for slot, s in enumerate(inv):
                members[s, fill[s]] = slot
                fill[s] += 1
            self._hier_coords.append(jnp.asarray(uniq, jnp.int32))
            self._hier_members.append(jnp.asarray(members))
            cur = uniq
            if len(uniq) <= max_top or len(self._hier_coords) >= 4:
                break
        # legacy two-level aliases (first super level)
        self._super_coords = self._hier_coords[0]
        self._super_members = self._hier_members[0]

    def populate_from_corners(self, corners):
        """corners: [N,3] integer block coords (reference
        populate_from_corners forest.py:162)."""
        occ = np.zeros(self.resolution, bool)
        c = np.asarray(corners, np.int64)
        occ[c[:, 0], c[:, 1], c[:, 2]] = True
        self.occupied[...] = jnp.asarray(occ)
        self._rebuild_slots()

    def populate_from_points(self, pts, dilate: int = 0):
        """Mark blocks containing any of `pts` (reference
        populate_from_mesh/waypoints are point-set driven)."""
        pts = np.asarray(pts)
        b = np.floor((pts - np.asarray(self.origin[...])) / self.block_size)
        b = b.astype(np.int64)
        res = np.asarray(self.resolution)
        keep = ((b >= 0) & (b < res)).all(-1)
        b = b[keep]
        occ = np.zeros(self.resolution, bool)
        occ[b[:, 0], b[:, 1], b[:, 2]] = True
        if dilate > 0:
            from scipy import ndimage  # optional; fall back to manual

            occ = ndimage.binary_dilation(occ, iterations=dilate)
        self.occupied[...] = jnp.asarray(occ)
        self._rebuild_slots()

    def populate_from_waypoints(self, waypoints, extend_units: int = 1):
        """Occupy blocks along a trajectory + neighbors (reference
        populate_from_waypoints forest.py:206)."""
        pts = np.asarray(waypoints)
        offs = np.arange(-extend_units, extend_units + 1)
        grid = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"), -1
                        ).reshape(-1, 3) * self.block_size
        all_pts = (pts[:, None, :] + grid[None]).reshape(-1, 3)
        self.populate_from_points(all_pts)

    def populate_from_mesh(self, verts, faces, samples_per_area: float = 64.0,
                           dilate: int = 0, seed: int = 0):
        """Occupy blocks intersecting a triangle mesh's surface (reference
        populate_from_mesh forest.py:176): area-weighted surface sampling →
        block marking, plus all triangle vertices."""
        verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int64)
        a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        n_total = int(max(1, samples_per_area * area.sum() /
                          max(self.block_size ** 2, 1e-12)))
        n_total = min(n_total, 2_000_000)
        rng = np.random.default_rng(seed)
        tri = rng.choice(len(faces), n_total, p=area / area.sum())
        u, v = rng.random(n_total), rng.random(n_total)
        flip = u + v > 1.0
        u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
        pts = (a[tri] + u[:, None] * (b - a)[tri] + v[:, None] * (c - a)[tri])
        self.populate_from_points(np.concatenate([pts, verts], 0),
                                  dilate=dilate)

    def populate_from_pinhole_cameras(self, c2ws, intrs, hw, near: float,
                                      far: float, n_samples_per_cam: int = 4096,
                                      dilate: int = 0, seed: int = 0):
        """Occupy blocks inside the union of pinhole view frusta (reference
        populate_from_pinhole_cameras forest.py:226): stratified samples of
        each frustum volume → block marking.

        c2ws [C,4,4] (or [C,3,4]) cam→world, intrs [C,3,3], hw (H, W)."""
        c2ws = np.asarray(c2ws, np.float64)
        intrs = np.asarray(intrs, np.float64)
        h, w = hw
        rng = np.random.default_rng(seed)
        all_pts = []
        for c2w, k in zip(c2ws, intrs):
            uv = rng.random((n_samples_per_cam, 2)) * np.asarray([w, h])
            # depth stratified in disparity (near-heavy, like frustum volume)
            z = 1.0 / (1.0 / near + rng.random(n_samples_per_cam)
                       * (1.0 / far - 1.0 / near))
            xc = (uv[:, 0] - k[0, 2]) / k[0, 0] * z
            yc = (uv[:, 1] - k[1, 2]) / k[1, 1] * z
            p_cam = np.stack([xc, yc, z], -1)
            all_pts.append(p_cam @ c2w[:3, :3].T + c2w[:3, 3])
        self.populate_from_points(np.concatenate(all_pts, 0), dilate=dilate)

    # ------------------------------------------------------------- mapping
    @property
    def block_coords(self) -> Array:
        """[n_trees, 3] integer coords of occupied blocks."""
        return self._block_coords

    def block_aabb(self) -> Array:
        """World AABB of the whole forest [2,3]."""
        o = self.origin[...]
        return jnp.stack([o, o + jnp.asarray(self.resolution, o.dtype)
                          * self.block_size])

    def block_of_points(self, x: Array) -> Array:
        """World points → block slot (−1 outside/empty)."""
        b = jnp.floor((x - self.origin[...]) / self.block_size).astype(jnp.int32)
        res = jnp.asarray(self.resolution)
        inb = jnp.all((b >= 0) & (b < res), axis=-1)
        b = jnp.clip(b, 0, res - 1)
        slot = self.block_idx[...][b[..., 0], b[..., 1], b[..., 2]]
        return jnp.where(inb, slot, -1)

    def normalize_coords(self, x: Array, bidx: Array) -> Array:
        """World → block-local [-1,1] for each point's block slot."""
        corners = self._block_coords[jnp.maximum(bidx, 0)]
        lo = self.origin[...] + corners.astype(x.dtype) * self.block_size
        return (x - lo) / self.block_size * 2.0 - 1.0

    # ------------------------------------------------------------- ray test
    def ray_test(self, rays_o: Array, rays_d: Array,
                 near: Optional[float] = None, far: Optional[float] = None
                 ) -> Dict[str, Array]:
        """Slab test against the forest bounds (per-block segments come from
        marching the block grid — `ray_march_blocks`)."""
        aabb = self.block_aabb()
        t_near, t_far, hit = ray_box_intersection(
            rays_o, rays_d, aabb[0], aabb[1], t_min=near or 0.0,
            t_max=far or 1e10)
        return {"near": t_near, "far": t_far, "mask": hit,
                "rays_o": rays_o, "rays_d": rays_d,
                "num_rays": rays_o.shape[0]}

    def _slab(self, lo: Array, hi: Array, rays_o: Array, rays_d: Array
              ) -> Tuple[Array, Array]:
        """Vectorized slab test: boxes [..., 3] vs rays [R, 3] →
        (t_in, t_out) [R, ...]."""
        o = rays_o[:, None, :]
        inv_d = 1.0 / jnp.where(jnp.abs(rays_d) < 1e-12,
                                jnp.full_like(rays_d, 1e-12), rays_d)
        inv_d = inv_d[:, None, :]
        t1 = (lo[None] - o) * inv_d
        t2 = (hi[None] - o) * inv_d
        return (jnp.max(jnp.minimum(t1, t2), axis=-1),
                jnp.min(jnp.maximum(t1, t2), axis=-1))

    def ray_test_segments(self, rays_o: Array, rays_d: Array,
                          near: Optional[Array] = None,
                          far: Optional[Array] = None,
                          max_segments: int = 32,
                          hierarchy: Optional[bool] = None,
                          coarse_keep: int = 16) -> Dict[str, Array]:
        """Per-ray block segments, entry-sorted — the reference's
        SPC-raytrace ray_test (forest.py:305-396, kaolin raytrace_cuda) as a
        static-shape pass. Small forests run one dense [R, n_trees] slab test
        + per-ray sort; large forests (or hierarchy=True) first cull against
        the supercell level (`_build_hierarchy`) and slab-test only the
        member blocks of the `coarse_keep` nearest supercell hits — the
        octree descent as two static-shape passes.

        Returns {seg_t_in, seg_t_out, seg_bidx, seg_mask [R,K], n_segs [R],
        near, far, mask} — the per-segment pack-info equivalent: segment k of
        ray r covers t ∈ [seg_t_in, seg_t_out) inside block slot seg_bidx.
        Blocks are disjoint, so segment order == global t order.
        """
        r_n = rays_o.shape[0]
        t_lo = jnp.zeros((r_n,), rays_o.dtype) if near is None \
            else jnp.broadcast_to(jnp.asarray(near), (r_n,))
        t_hi = jnp.full((r_n,), 1e10, rays_o.dtype) if far is None \
            else jnp.broadcast_to(jnp.asarray(far), (r_n,))
        if hierarchy is None:
            hierarchy = self.n_trees > 4096

        blk_lo = (self.origin[...][None]
                  + self._block_coords.astype(rays_o.dtype) * self.block_size)
        if hierarchy and self._super_coords.shape[0] > 0:
            f = self._hier_factor
            T = len(self._hier_coords)                 # super levels, ≥ 1
            kc = int(coarse_keep)
            o = rays_o[:, None, :]
            inv_d = 1.0 / jnp.where(jnp.abs(rays_d) < 1e-12,
                                    jnp.full_like(rays_d, 1e-12), rays_d)
            inv_d = inv_d[:, None, :]

            def boxes_t(lo, size):
                t1 = (lo - o) * inv_d
                t2 = (lo + size - o) * inv_d
                return (jnp.max(jnp.minimum(t1, t2), -1),
                        jnp.min(jnp.maximum(t1, t2), -1))

            # dense test of the coarsest level
            size_T = self.block_size * f ** T
            s_lo = (self.origin[...][None]
                    + self._hier_coords[T - 1].astype(rays_o.dtype) * size_T)
            ts_in, ts_out = self._slab(s_lo, s_lo + size_T, rays_o, rays_d)
            s_hit = (jnp.maximum(ts_in, t_lo[:, None])
                     < jnp.minimum(ts_out, t_hi[:, None]))
            kT = min(kc, ts_in.shape[1])
            iota = jnp.broadcast_to(
                jnp.arange(ts_in.shape[1], dtype=jnp.int32)[None],
                ts_in.shape)
            kept_idx, kept_valid = _topk_by_key(
                jnp.where(s_hit, ts_in, jnp.inf),
                (iota, s_hit.astype(jnp.int32)), kT)                # [R,K]
            kept_valid = kept_valid.astype(bool)

            # descend: expand children of the K nearest hits per level
            for i in range(T, 0, -1):
                cand = self._hier_members[i - 1][kept_idx]     # [R,K,f³]
                cand = jnp.where(kept_valid[..., None], cand, -1
                                 ).reshape(r_n, -1)            # [R,K·f³]
                safe = jnp.maximum(cand, 0)
                size_c = self.block_size * f ** (i - 1)
                if i - 1 == 0:
                    lo = blk_lo[safe]
                else:
                    lo = (self.origin[...][None]
                          + self._hier_coords[i - 2].astype(rays_o.dtype)
                          [safe] * size_c)
                t_in, t_out = boxes_t(lo, size_c)              # [R,K·f³]
                valid = ((cand >= 0)
                         & (jnp.maximum(t_in, t_lo[:, None])
                            < jnp.minimum(t_out, t_hi[:, None])))
                if i - 1 == 0:
                    bidx_cand = cand
                    break
                kept_idx, kept_valid = _topk_by_key(
                    jnp.where(valid, t_in, jnp.inf),
                    (safe, valid.astype(jnp.int32)), kc)
                kept_valid = kept_valid.astype(bool)
        else:
            t_in, t_out = self._slab(blk_lo, blk_lo + self.block_size,
                                     rays_o, rays_d)               # [R,B]
            valid = jnp.ones_like(t_in, bool)
            bidx_cand = jnp.broadcast_to(
                jnp.arange(t_in.shape[1], dtype=jnp.int32)[None], t_in.shape)

        t_in = jnp.maximum(t_in, t_lo[:, None])
        t_out = jnp.minimum(t_out, t_hi[:, None])
        hit = valid & (t_in < t_out)

        k = min(int(max_segments), t_in.shape[1])
        seg_t_in, seg_t_out, seg_mask, seg_bidx = _topk_by_key(
            jnp.where(hit, t_in, jnp.inf),
            (t_in, t_out, hit.astype(jnp.int32), bidx_cand), k)
        seg_mask = seg_mask.astype(bool)
        seg_bidx = jnp.where(seg_mask, seg_bidx, -1)
        n_segs = jnp.sum(seg_mask.astype(jnp.int32), axis=1)
        ray_near = jnp.where(seg_mask[:, 0], seg_t_in[:, 0], t_lo)
        last = jnp.max(jnp.where(seg_mask, seg_t_out, -jnp.inf), axis=1)
        ray_far = jnp.where(n_segs > 0, last, t_hi)
        return {"seg_t_in": seg_t_in, "seg_t_out": seg_t_out,
                "seg_bidx": seg_bidx, "seg_mask": seg_mask, "n_segs": n_segs,
                "near": ray_near, "far": ray_far, "mask": n_segs > 0,
                "rays_o": rays_o, "rays_d": rays_d,
                "num_rays": rays_o.shape[0]}

    def march_segments(self, segs: Dict[str, Array], *,
                       steps_per_segment: int, perturb_key=None
                       ) -> Tuple[Array, Array, Array, Array]:
        """Sample inside each block segment (reference forest_marching.cu:27
        in-segment stepping): S uniform steps per segment, concatenated in
        segment order → globally t-sorted because blocks are disjoint.

        → (t [R, K·S], dt [R, K·S], bidx [R, K·S], mask [R, K·S]); capacity
        is spent only inside occupied blocks — the empty inter-block space
        the fixed-step marcher burns slots on never appears.
        """
        s = int(steps_per_segment)
        t_in, t_out = segs["seg_t_in"], segs["seg_t_out"]          # [R,K]
        r, k = t_in.shape
        length = jnp.maximum(t_out - t_in, 0.0)
        dt = (length / s)[..., None]                               # [R,K,1]
        if perturb_key is not None:
            u = jax.random.uniform(perturb_key, (r, k, s), t_in.dtype)
        else:
            u = 0.5
        i = jnp.arange(s, dtype=t_in.dtype)
        t = t_in[..., None] + (i + u) * dt                         # [R,K,S]
        mask = segs["seg_mask"][..., None] & (t < t_out[..., None])
        bidx = jnp.broadcast_to(segs["seg_bidx"][..., None], (r, k, s))
        return (t.reshape(r, k * s), jnp.broadcast_to(dt, (r, k, s)
                                                      ).reshape(r, k * s),
                bidx.reshape(r, k * s), mask.reshape(r, k * s))

    def ray_march_blocks(self, rays_o: Array, rays_d: Array, near: Array,
                         far: Array, *, n_steps: int, step_size: float,
                         perturb_key=None) -> Tuple[Array, Array, Array, Array]:
        """March world rays; per candidate sample return its block slot.

        → (t [R,S], dt [R,S], bidx [R,S] (−1 empty), mask [R,S]).
        Replaces the reference's SPC raytrace + forest_ray_marching
        (SURVEY.md §3.5): empty-block samples are masked, per-segment pack
        bookkeeping is unnecessary because samples stay globally t-sorted.
        """
        from nr3d_lib_tpu.ops.occgrid_march import march_steps

        t, dt, in_range = march_steps(near, far, n_steps, step_size,
                                      perturb_key=perturb_key)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        bidx = self.block_of_points(x)
        mask = in_range & (bidx >= 0)
        return t, dt, bidx, mask

    def state_dict(self):
        return {"occupied": self.occupied[...], "origin": self.origin[...],
                "block_idx": self.block_idx[...]}

    def load_state_dict(self, sd):
        self.occupied[...] = jnp.asarray(sd["occupied"])
        self.origin[...] = jnp.asarray(sd["origin"])
        self.block_idx[...] = jnp.asarray(sd["block_idx"])
        self._rebuild_slots()
