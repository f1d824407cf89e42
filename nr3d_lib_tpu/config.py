"""Config system: YAML + CLI-dotlist merged attribute-dicts.

Re-design of the reference's OmegaConf/addict config stack
(reference: nr3d_lib/config.py:18-148). Same semantics without the OmegaConf
dependency:

  * ``ConfigDict`` — dict with attribute access, recursive wrapping, deepcopy.
  * ``load_config(path)`` — YAML load (+ optional ``_base_`` includes).
  * ``merge_dotlist(cfg, ["a.b.c=1", ...])`` — CLI override semantics.
  * ``BaseConfig.parse()`` — priority: CLI dotlist > argparse > --config yaml
    > base yaml (reference: nr3d_lib/config.py:90-98), plus ``--resume_dir``
    reloading a persisted config (reference: nr3d_lib/config.py:123-130).
  * String resolvers ``${eval:...}`` and ``${import:...}`` mirroring the
    reference's OmegaConf resolvers (reference: nr3d_lib/config.py:18-19).
"""

from __future__ import annotations

import argparse
import copy
import importlib
import os
import re
from numbers import Number
from typing import Any, Dict, List, Optional, Sequence, Union


__all__ = [
    "ConfigDict",
    "load_config",
    "save_config",
    "merge_dicts",
    "merge_dotlist",
    "parse_value",
    "resolve",
    "BaseConfig",
    "parse_device_ids",
]


class ConfigDict(dict):
    """A dict with attribute access; nested dicts are wrapped recursively."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = v
            else:
                for k, v in arg:
                    self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def copy(self) -> "ConfigDict":
        return copy.deepcopy(self)

    def deepcopy(self) -> "ConfigDict":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        def un(v):
            if isinstance(v, dict):
                return {k: un(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [un(x) for x in v]
            return v

        return un(self)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def pop(self, key, *args):
        return super().pop(key, *args)


def merge_dicts(base: dict, override: dict, allow_new: bool = True) -> ConfigDict:
    """Recursively merge ``override`` into a deep copy of ``base``."""
    out = ConfigDict(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v, allow_new=allow_new)
        else:
            if not allow_new and k not in out:
                raise KeyError(f"Unknown config key: {k}")
            out[k] = copy.deepcopy(v)
    return out


def parse_value(text: str) -> Any:
    """Parse a CLI value string with YAML semantics ('1'→int, 'true'→bool...)."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def merge_dotlist(cfg: dict, dotlist: Sequence[str]) -> ConfigDict:
    """Apply ``a.b.c=value`` overrides (creates intermediate dicts)."""
    out = ConfigDict(copy.deepcopy(dict(cfg)))
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Dotlist item must look like key=value, got: {item!r}")
        key, value = item.split("=", 1)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = ConfigDict()
            node = node[p]
        node[parts[-1]] = parse_value(value)
    return out


_RESOLVER_RE = re.compile(r"^\$\{(eval|import):(.*)\}$", re.DOTALL)


def resolve(cfg: Any) -> Any:
    """Resolve ``${eval:...}`` / ``${import:...}`` strings recursively.

    Mirrors the reference's OmegaConf resolvers (nr3d_lib/config.py:18-19).
    """
    if isinstance(cfg, dict):
        return ConfigDict({k: resolve(v) for k, v in cfg.items()})
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(resolve(v) for v in cfg)
    if isinstance(cfg, str):
        m = _RESOLVER_RE.match(cfg.strip())
        if m is not None:
            kind, expr = m.group(1), m.group(2)
            if kind == "eval":
                import math

                return eval(expr, {"math": math, "np": __import__("numpy")})
            if kind == "import":
                return import_str(expr.strip())
    return cfg


def import_str(string: str):
    """Import ``pkg.mod.attr`` (reference: nr3d_lib/utils.py import_str)."""
    module, _, attr = string.rpartition(".")
    if not module:
        return importlib.import_module(attr)
    return getattr(importlib.import_module(module), attr)


def load_config(path: Union[str, os.PathLike], resolve_exprs: bool = True) -> ConfigDict:
    """Load a YAML config; a top-level ``_base_`` key includes parent yaml(s)."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    base_paths = raw.pop("_base_", None)
    cfg = ConfigDict(raw)
    if base_paths is not None:
        if isinstance(base_paths, str):
            base_paths = [base_paths]
        merged = ConfigDict()
        for bp in base_paths:
            bp_abs = bp if os.path.isabs(bp) else os.path.join(os.path.dirname(str(path)), bp)
            merged = merge_dicts(merged, load_config(bp_abs, resolve_exprs=False))
        cfg = merge_dicts(merged, cfg)
    if resolve_exprs:
        cfg = resolve(cfg)
    return cfg


def instantiate(cfg: dict, **overrides):
    """Build an object from ``{"target": "pkg.mod.Class", "param": {...}}``
    — the downstream construction pattern the reference's configs use
    (import resolver + nested param dicts, reference config.py:18-19).
    ``overrides`` are merged over ``param`` (e.g. runtime seeds)."""
    cfg = ConfigDict(cfg)
    target = import_str(cfg["target"])
    param = ConfigDict(cfg.get("param", {})).to_dict()
    param.update(overrides)
    return target(**param)


def save_config(cfg: dict, path: Union[str, os.PathLike]):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(ConfigDict(cfg).to_dict(), f, sort_keys=False)


def parse_device_ids(value: Union[str, int, Sequence[int], None]) -> List[int]:
    """Parse '0', '0,1,2', [0,1] → list of device ordinals.

    Reference: nr3d_lib/config.py:36 (parse_device_ids).
    """
    if value is None:
        return [0]
    if isinstance(value, Number):
        return [int(value)]
    if isinstance(value, str):
        return [int(v) for v in value.replace(" ", "").split(",") if v != ""]
    return [int(v) for v in value]


class BaseConfig:
    """CLI + YAML config parser.

    Priority (highest first): CLI dotlist > argparse flags > ``--config`` yaml.
    ``--resume_dir`` re-reads the persisted ``config.yaml`` from a previous
    run (reference: nr3d_lib/config.py:80-148).
    """

    def __init__(self, parser: Optional[argparse.ArgumentParser] = None):
        self.parser = parser or argparse.ArgumentParser(add_help=True)
        self.parser.add_argument("--config", type=str, default=None, help="Path to YAML config.")
        self.parser.add_argument("--resume_dir", type=str, default=None,
                                 help="Experiment dir to resume; reloads its config.yaml.")
        self.parser.add_argument("--device_ids", type=str, default="0")

    def parse(self, argv: Optional[Sequence[str]] = None, print_config: bool = False) -> ConfigDict:
        args, unknown = self.parser.parse_known_args(argv)
        dotlist = [u for u in unknown if "=" in u and not u.startswith("--")]

        cfg = ConfigDict()
        if args.resume_dir is not None:
            persisted = os.path.join(args.resume_dir, "config.yaml")
            if os.path.exists(persisted):
                cfg = load_config(persisted)
            cfg.training = cfg.get("training", ConfigDict())
            cfg.exp_dir = args.resume_dir
        elif args.config is not None:
            cfg = load_config(args.config)

        for k, v in vars(args).items():
            if k in ("config", "resume_dir") or v is None:
                continue
            if k == "device_ids":
                cfg[k] = parse_device_ids(v)
            else:
                cfg.setdefault(k, v)

        cfg = merge_dotlist(cfg, dotlist)
        cfg = resolve(cfg)
        if print_config:
            import yaml

            print(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
        return cfg
