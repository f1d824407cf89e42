"""Debug data-layers: live model/accel state → named line-set geometry.

Reference: nr3d_lib/gui/datalayers/ (occgrid_layers.py, forest_layers.py,
octree_layers.py) — the interactive viewer's debug overlays. An accelerator host has
no display, so layers here return plain ``{"name", "points", "edges",
"color"}`` dicts that feed ``plot.plot_lineset`` (matplotlib), any
open3d/vedo ``LineSet`` downstream, or file export — the same geometry the
reference pushes into its wisp GL canvas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from nr3d_lib_tpu.plot.plot_3d import (camera_frustum_lines,
                                       forest_block_lines, merge_linesets,
                                       occgrid_box_lines)

__all__ = ["occgrid_datalayer", "forest_datalayer", "camera_datalayer",
           "aabb_datalayer", "save_linesets_ply"]

Lineset = Dict[str, np.ndarray]


def _layer(name: str, pts, segs, color) -> Lineset:
    return {"name": name, "points": np.asarray(pts, np.float32),
            "edges": np.asarray(segs, np.int32),
            "color": np.asarray(color, np.float32)}


def occgrid_datalayer(accel, name: str = "occgrid",
                      color=(1.0, 0.55, 0.0)) -> Lineset:
    """Occupied cells of a single/dynamic occ-grid accel as wireframe boxes
    (reference: gui/datalayers/occgrid_layers.py). Uses the accel's space
    AABB when bound, else [-1,1]³."""
    occ = np.asarray(accel.occ.occ() if hasattr(accel.occ, "occ")
                     else accel.occ())
    lo, hi = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)
    space = getattr(accel, "space", None)
    if space is not None and hasattr(space, "aabb"):
        ab = np.asarray(space.aabb[...])
        lo, hi = ab[0], ab[1]
    pts, segs = occgrid_box_lines(occ, lo, hi)
    return _layer(name, pts, segs, color)


def forest_datalayer(space, accel=None, name: str = "forest",
                     color=(0.1, 0.7, 0.3)) -> List[Lineset]:
    """Forest block outlines, plus per-block occupied cells when an
    OccGridAccelForest is given (reference: forest_layers.py)."""
    layers = [_layer(name + "/blocks", *forest_block_lines(space), color)]
    if accel is not None:
        occ = np.asarray(accel.occ.occ())                  # [n_trees, r,r,r]
        o = np.asarray(space.origin[...])
        bs = space.block_size
        cells = []
        for slot, c in enumerate(np.asarray(space.block_coords)):
            lo = o + c * bs
            pts, segs = occgrid_box_lines(occ[slot], lo, lo + bs,
                                          max_boxes=512)
            if len(pts):
                cells.append((pts, segs))
        if cells:
            pts, segs = merge_linesets(cells)
            layers.append(_layer(name + "/cells", pts, segs,
                                 (1.0, 0.55, 0.0)))
    return layers


def camera_datalayer(c2ws, intr, hw, scale: float = 0.3,
                     name: str = "cameras",
                     color=(0.2, 0.4, 1.0)) -> Lineset:
    """View frusta of a camera set (reference: the viewer's camera gizmos)."""
    c2ws = np.asarray(c2ws).reshape(-1, 4, 4)
    pts, segs = merge_linesets(
        [camera_frustum_lines(c2w, intr, hw, scale) for c2w in c2ws])
    return _layer(name, pts, segs, color)


def aabb_datalayer(aabb, name: str = "aabb",
                   color=(0.6, 0.6, 0.6)) -> Lineset:
    """A single AABB [2,3] outline."""
    ab = np.asarray(aabb, np.float32)
    occ = np.ones((1, 1, 1), bool)
    pts, segs = occgrid_box_lines(occ, ab[0], ab[1])
    return _layer(name, pts, segs, color)


def save_linesets_ply(path: str, layers: Sequence[Lineset]):
    """Export layers to an ASCII PLY with edges — openable in meshlab /
    open3d (the offline stand-in for the reference's live GL canvas)."""
    pts, segs = merge_linesets([(l["points"], l["edges"]) for l in layers])
    cols = np.concatenate([
        np.tile((np.asarray(l["color"]) * 255).astype(np.uint8),
                (len(l["points"]), 1)) for l in layers])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(segs)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
        for a, b in segs:
            f.write(f"{a} {b}\n")


def project_datalayer(layer: Lineset, intr, c2w,
                      hw) -> "tuple[np.ndarray, np.ndarray]":
    """Project a line-set layer into pixel space: returns (p0, p1) [S,2]
    segment endpoints; segments with an endpoint behind the camera are
    culled (the reference GL canvas clips; sampling-paint overlays can't).
    """
    intr = np.asarray(intr, np.float32)
    c2w = np.asarray(c2w, np.float32)
    R, t = c2w[:3, :3], c2w[:3, 3]
    pts_cam = (np.asarray(layer["points"], np.float32) - t) @ R  # w2c
    z = pts_cam[:, 2]
    uv = pts_cam[:, :2] / np.maximum(z[:, None], 1e-9)
    pix = uv @ intr[:2, :2].T + intr[:2, 2]
    e = np.asarray(layer["edges"], np.int64)
    ok = (z[e[:, 0]] > 1e-3) & (z[e[:, 1]] > 1e-3)
    e = e[ok]
    return pix[e[:, 0]], pix[e[:, 1]]


def draw_datalayers(img: np.ndarray, layers: Sequence[Lineset], intr, c2w
                    ) -> np.ndarray:
    """Paint projected line-set layers over a rendered uint8 frame (the
    offline/HTTP equivalent of the reference viewer's debug overlays)."""
    from nr3d_lib_tpu.plot.plot_basic import draw_segments_2d

    hw = img.shape[:2]
    for layer in layers:
        p0, p1 = project_datalayer(layer, intr, c2w, hw)
        color = (np.clip(np.asarray(layer.get("color", (0, 1, 0))), 0, 1)
                 * 255).astype(np.uint8)
        img = draw_segments_2d(img, p0, p1, color=tuple(int(c) for c in color))
    return img
