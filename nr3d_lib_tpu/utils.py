"""Generic utilities: nested-dict tooling, dtype helpers, stats, image IO.

Counterpart of the reference's grab-bag utils
(reference: nr3d_lib/utils.py:44-1061). Torch-specific helpers become JAX
equivalents (`check_to_jax`, pytree collate); CUDA micro-benchmarks become a
`block_until_ready` timing harness.
"""

from __future__ import annotations

import functools
import importlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "enable_compile_cache",
    "import_str",
    "nested_dict_keys",
    "nested_dict_items",
    "nested_dict_get",
    "nested_dict_set",
    "collate_nested_dict",
    "cond_mkdir",
    "jax_dtype",
    "check_to_jax",
    "tensor_statistics",
    "timeit_jax",
    "img_to_uint8",
    "load_rgb",
    "save_image",
    "save_video",
    "downscale_img",
    "chunked",
]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here. Otherwise the cache is the fixed
    ``<repo>/.jax_cache`` (a fixed path: the path is part of the key, so a
    moving directory never hits)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

def import_str(string: str):
    """Import ``pkg.mod.attr`` from a dotted string (reference: utils.py import_str)."""
    module, _, attr = string.rpartition(".")
    if not module:
        return importlib.import_module(attr)
    return getattr(importlib.import_module(module), attr)


# ----------------------------------------------------------------- nested dict
def nested_dict_keys(d: dict, prefix: tuple = ()) -> List[tuple]:
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out += nested_dict_keys(v, prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


def nested_dict_items(d: dict, prefix: tuple = ()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from nested_dict_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def nested_dict_get(d: dict, keys: Sequence, default=None):
    node = d
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def nested_dict_set(d: dict, keys: Sequence, value):
    node = d
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def collate_nested_dict(dicts: Sequence[dict], stack: bool = True):
    """Collate a list of nested dicts of arrays into one nested dict.

    Reference: nr3d_lib/utils.py collate_nested_dict.
    """
    import jax.numpy as jnp

    if len(dicts) == 0:
        return {}
    first = dicts[0]
    out = {}
    for k, v in first.items():
        vs = [d[k] for d in dicts]
        if isinstance(v, dict):
            out[k] = collate_nested_dict(vs, stack=stack)
        elif hasattr(v, "shape") or isinstance(v, (int, float)):
            out[k] = jnp.stack(vs) if stack else jnp.concatenate(vs)
        else:
            out[k] = vs
    return out


def cond_mkdir(path: str):
    import os

    os.makedirs(path, exist_ok=True)


# ---------------------------------------------------------------------- dtypes
def jax_dtype(dtype: Union[str, Any, None]):
    """'half'/'float16'/'bf16'/... → jnp dtype (reference: utils.py torch_dtype)."""
    import jax.numpy as jnp

    if dtype is None:
        return jnp.float32
    if isinstance(dtype, str):
        table = {
            "half": jnp.bfloat16, "float16": jnp.float16, "fp16": jnp.float16,
            "bfloat16": jnp.bfloat16, "bf16": jnp.bfloat16,
            "float": jnp.float32, "float32": jnp.float32, "fp32": jnp.float32,
            "double": jnp.float64, "float64": jnp.float64,
            "int": jnp.int32, "int32": jnp.int32, "int64": jnp.int64,
            "uint8": jnp.uint8, "bool": jnp.bool_,
        }
        return table[dtype]
    return jnp.dtype(dtype)


def check_to_jax(x, dtype=None, ref=None):
    """Convert array-likes / lists / nested dicts to jnp arrays.

    Reference: nr3d_lib/utils.py check_to_torch.
    """
    import jax.numpy as jnp

    if dtype is None and ref is not None:
        dtype = ref.dtype
    if isinstance(x, dict):
        return {k: check_to_jax(v, dtype=dtype, ref=ref) for k, v in x.items()}
    if x is None:
        return None
    arr = jnp.asarray(x)
    if dtype is not None and np.issubdtype(np.asarray(arr).dtype, np.floating):
        arr = arr.astype(dtype)
    return arr


# ----------------------------------------------------------------------- stats
def tensor_statistics(x, prefix: str = "") -> Dict[str, float]:
    """Summary stats dict for logging (reference: utils.py:767)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    if x.size == 0:
        return {}
    p = lambda k: f"{prefix}.{k}" if prefix else k
    return {
        p("mean"): float(x.mean()), p("std"): float(x.std()),
        p("min"): float(x.min()), p("max"): float(x.max()),
        p("absmax"): float(np.abs(x).max()),
        p("norm"): float(np.linalg.norm(x)),
    }


# ------------------------------------------------------------------- benchmark
def timeit_jax(fn: Callable, *args, n_iters: int = 20, warmup: int = 3, **kwargs) -> float:
    """Median wall ms per call with async-dispatch flushing.

    Replaces the reference's CUDA-event / torch Timer micro-benchmarks
    (reference: utils.py:1056-1061).
    """
    import jax

    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


# -------------------------------------------------------------------- images
def img_to_uint8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def load_rgb(path: str, downscale: float = 1.0) -> np.ndarray:
    """Load image → float32 [H,W,3] in [0,1] (reference: utils.py load_rgb)."""
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    except ImportError:
        import matplotlib.pyplot as plt

        img = plt.imread(path).astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        img = img[..., :3]
    if downscale != 1.0:
        img = downscale_img(img, downscale)
    return img


def downscale_img(img: np.ndarray, factor: float) -> np.ndarray:
    """Area downscale by integer factor via block mean."""
    f = int(factor)
    h, w = img.shape[:2]
    h2, w2 = h // f * f, w // f * f
    img = img[:h2, :w2]
    return img.reshape(h2 // f, f, w2 // f, f, -1).mean(axis=(1, 3)).squeeze()


def save_image(path: str, img) -> None:
    """Save float [0,1] or uint8 image (reference: utils.py image IO)."""
    arr = img_to_uint8(img)
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:
        import matplotlib.pyplot as plt

        plt.imsave(path, arr)


def save_video(path: str, frames: Sequence, fps: int = 24) -> str:
    """Write frames ([T,H,W,3] float [0,1] or uint8) to a video file
    (reference: utils.py save_video). Falls back to a PNG sequence
    directory when no video writer (imageio/ffmpeg) is available; returns
    the path actually written.
    """
    import os

    frames_u8 = [img_to_uint8(f) for f in frames]
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames_u8, fps=fps)
        return path
    except Exception:
        if os.path.exists(path):   # don't leave a truncated video behind
            os.remove(path)
        root = os.path.splitext(path)[0] + "_frames"
        cond_mkdir(root)
        for i, f in enumerate(frames_u8):
            save_image(os.path.join(root, f"{i:05d}.png"), f)
        return root


def chunked(total: int, chunk: int):
    """Yield (start, size) spans covering [0, total)."""
    for start in range(0, total, chunk):
        yield start, min(chunk, total - start)


def backup_project(backup_dir: str, source_dir: str = "./",
                   subdirs_to_copy: Sequence[str] = ("nr3d_lib_tpu",
                                                     "examples"),
                   filetypes_to_copy: Sequence[str] = (".py", ".yaml", ".sh",
                                                      ".cpp", ".h")) -> None:
    """Snapshot source files into an experiment directory for
    reproducibility (reference: utils.py:942 backup_project — root at
    depth 1, listed subdirs recursively)."""
    import shutil

    exts = tuple(filetypes_to_copy)

    def _copy_tree(dst_root, src_root, recursive):
        os.makedirs(dst_root, exist_ok=True)
        for name in sorted(os.listdir(src_root)):
            src = os.path.join(src_root, name)
            dst = os.path.join(dst_root, name)
            if os.path.isfile(src) and src.endswith(exts):
                shutil.copy2(src, dst)
            elif recursive and os.path.isdir(src) and not name.startswith("."):
                _copy_tree(dst, src, True)

    _copy_tree(backup_dir, source_dir, False)
    for sub in subdirs_to_copy:
        src = os.path.join(source_dir, sub)
        if os.path.isdir(src):
            _copy_tree(os.path.join(backup_dir, sub), src, True)
