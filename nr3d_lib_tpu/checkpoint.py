"""Checkpoint IO: named-module registry → single numpy ``.npz`` file.

Equivalent of the reference's `CheckpointIO`
(reference: nr3d_lib/checkpoint.py:19-166): register named modules, save
their states plus extra scalars into one file, load with ignore/only-use key
filters, and pick up the newest checkpoint with `sorted_ckpts` ordering
(final > latest > highest-iteration).

Registered objects may be:
  * a raw pytree of arrays (nested dicts; saved as-is),
  * an object with ``state_dict()`` / ``load_state_dict()``,
  * an `nn.Module` (saved via ``nn.state``, restored via ``nn.update``).

In the file, nested keys are joined with ``/``; extra scalars live under
``__extras__/``.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from nr3d_lib_tpu import nn

__all__ = ["CheckpointIO", "sorted_ckpts"]

_SEP = "/"
_EXTRAS = "__extras__"


def _get_state(obj) -> Any:
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if isinstance(obj, nn.Module):
        return nn.state(obj)
    return obj  # raw pytree


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{_SEP}{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of `_flatten`; digit keys (list positions) become ints."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = [int(p) if p.lstrip("-").isdigit() else p
                 for p in key.split(_SEP)]
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def sorted_ckpts(ckpt_dir: str, ext: str = ".npz") -> List[str]:
    """Order: final > latest > highest iteration (reference: checkpoint.py:136-166)."""
    paths = sorted(glob(os.path.join(ckpt_dir, f"*{ext}")))
    final, latest, iters = [], [], []
    for p in paths:
        name = os.path.basename(p)
        if "final" in name:
            final.append(p)
        elif "latest" in name:
            latest.append(p)
        else:
            m = re.search(r"(\d+)", name)
            iters.append((int(m.group(1)) if m else -1, p))
    iters = [p for _, p in sorted(iters)]
    return iters + latest + final  # last element = the one to resume from


class CheckpointIO:
    def __init__(self, checkpoint_dir: str = "./ckpts", allow_mkdir: bool = True):
        self.checkpoint_dir = checkpoint_dir
        if allow_mkdir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.module_dict: Dict[str, Any] = {}

    def register_modules(self, **kwargs):
        self.module_dict.update(kwargs)

    # ------------------------------------------------------------------ save
    def save(self, filename: str, **extra_scalars) -> str:
        if not os.path.isabs(filename):
            filename = os.path.join(self.checkpoint_dir, filename)
        flat: Dict[str, np.ndarray] = {}
        for k, m in self.module_dict.items():
            _flatten(_get_state(m), k, flat)
        _flatten(dict(extra_scalars), _EXTRAS, flat)
        # np.savez appends ".npz" to other names; write through a handle
        with open(filename, "wb") as f:
            np.savez(f, **flat)
        return filename

    # ------------------------------------------------------------------ load
    def load(self, filename: str,
             ignore_keys: Sequence[str] = (),
             only_use_keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        if not os.path.isabs(filename) and not os.path.exists(filename):
            filename = os.path.join(self.checkpoint_dir, filename)
        with np.load(filename, allow_pickle=False) as z:
            payload = _unflatten({k: z[k] for k in z.files})
        extras = {k: (v.item() if v.ndim == 0 else v)
                  for k, v in payload.pop(_EXTRAS, {}).items()}
        for name, state in payload.items():
            if name in ignore_keys:
                continue
            if only_use_keys is not None and name not in only_use_keys:
                continue
            if name not in self.module_dict:
                continue
            obj = self.module_dict[name]
            if hasattr(obj, "before_load_state_dict"):
                # shape-dependent rebuild hook (reference: lotd_neus.py:96)
                obj.before_load_state_dict(state)
            if hasattr(obj, "load_state_dict"):
                obj.load_state_dict(state)
            elif isinstance(obj, nn.Module):
                nn.update(obj, state)
            else:
                self.module_dict[name] = state
        return extras

    def load_latest(self, **kwargs) -> Optional[Dict[str, Any]]:
        ordered = sorted_ckpts(self.checkpoint_dir)
        if not ordered:
            return None
        return self.load(ordered[-1], **kwargs)
