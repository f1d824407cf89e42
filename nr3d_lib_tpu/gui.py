"""Offline neural renderer — the GUI substitute.

The reference ships a kaolin-wisp OpenGL/imgui/pycuda interactive viewer
(reference: nr3d_lib/gui/ — NR3DKaolinWispRenderer gui/neural_renderer.py:
18-55 bridges model.ray_query → RGBA/depth buffers). An accelerator host has no
display; the equivalent surface here is an offline renderer with the same
bridge (model.ray_query → image buffers) producing stills, turntable image
sequences, and mp4/gif when imageio/ffmpeg exist.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NeuralRenderer", "render_turntable"]


class NeuralRenderer:
    """Bridges `model.ray_test/ray_query` to image buffers
    (reference: NR3DKaolinWispRenderer.render)."""

    def __init__(self, model, hw: Tuple[int, int] = (256, 256),
                 intr=None, ray_chunk: int = 8192):
        from nr3d_lib_tpu.graphics.cameras import pixel_grid

        self.model = model
        self.h, self.w = hw
        if intr is None:
            f = 1.2 * max(hw)
            intr = jnp.asarray([[f, 0.0, self.w / 2],
                                [0.0, f, self.h / 2], [0.0, 0.0, 1.0]])
        self.intr = jnp.asarray(intr)
        self.uv = pixel_grid(self.h, self.w).reshape(-1, 2)
        self.ray_chunk = ray_chunk

    def render(self, c2w, key=None, with_rgb: bool = True,
               ray_extras: Optional[Dict[str, float]] = None
               ) -> Dict[str, np.ndarray]:
        """ray_extras: scalar per-frame conditions broadcast to every ray —
        e.g. {"ts": 0.3} for dynamic models, {"bidx": 2} for batched/
        conditional ones (keys ending in "idx" broadcast as int32)."""
        from nr3d_lib_tpu.graphics.cameras import pinhole_get_rays

        o, d = pinhole_get_rays(self.uv, self.intr, jnp.asarray(c2w))
        outs = {}
        for s in range(0, o.shape[0], self.ray_chunk):
            rt = self.model.ray_test(o[s:s + self.ray_chunk],
                                     d[s:s + self.ray_chunk])
            n = rt["rays_o"].shape[0]
            for name, val in (ray_extras or {}).items():
                dt = jnp.int32 if name.endswith("idx") else jnp.float32
                rt[name] = jnp.full((n,), val, dt)
            rendered, _ = self.model.ray_query(rt, key=key, with_rgb=with_rgb)
            for k, v in rendered.items():
                outs.setdefault(k, []).append(np.asarray(v))
        images = {}
        for k, chunks in outs.items():
            arr = np.concatenate(chunks, axis=0)
            images[k] = arr.reshape((self.h, self.w) + arr.shape[1:])
        return images


def render_turntable(model, *, n_frames: int = 12, radius: float = 3.0,
                     elevation: float = 0.4, hw: Tuple[int, int] = (128, 128),
                     out_dir: Optional[str] = None, key=None
                     ) -> Sequence[np.ndarray]:
    """Orbit the model and render frames (optionally save pngs / mp4)."""
    from nr3d_lib_tpu.graphics.cameras import spherical_camera_path
    from nr3d_lib_tpu.utils import img_to_uint8

    renderer = NeuralRenderer(model, hw)
    poses = spherical_camera_path(n_frames, radius, elevation)
    frames = []
    for i in range(n_frames):
        images = renderer.render(poses[i], key=key)
        frames.append(img_to_uint8(images["rgb_volume"]))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        from nr3d_lib_tpu.logger import _write_png

        for i, f in enumerate(frames):
            _write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), f)
        # save_video falls back to a PNG sequence dir when no imageio/ffmpeg
        # (the per-frame PNGs above are already the canonical output)
        from nr3d_lib_tpu.utils import save_video

        save_video(os.path.join(out_dir, "turntable.mp4"), frames, fps=10)
    return frames
