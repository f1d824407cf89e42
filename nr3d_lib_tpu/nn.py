"""A small module system: stateful objects whose arrays split out as pytrees.

A `Module` is a plain Python object. Its *state* is every `Variable`
(`Param` is the trainable kind) and every array held directly as an
attribute, found by walking attributes, `List` / `Dict` containers and
sub-modules. Everything else (ints, strings, configs, callables) is static
structure.

    graphdef, params, rest = split(model, Param, ...)
    def loss(params):
        m = merge(graphdef, params, rest)   # a fresh copy holding `params`
        ...
    update(model, new_params)               # write values back in place

A state is a nested ``dict`` of arrays keyed by attribute name (list
positions are ``int`` keys), so it is a pytree that optax, `jax.grad` and
`jax.jit` take as it is. A sub-module reachable along two paths is one
object: it is stored once, at its first path in sorted attribute order, and
`merge` rebuilds the sharing.

`pytree_dataclass` / `static_field` register frozen dataclasses as pytrees
(`jax.tree_util.register_dataclass`), with a `replace` method.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict as _TDict, List as _TList, Tuple

import jax
import numpy as np

__all__ = ["Module", "Variable", "Param", "List", "Dict", "Rngs", "GraphDef",
           "split", "merge", "state", "update", "pytree_dataclass",
           "static_field"]


class Variable:
    """A mutable box holding one array. Read with ``v[...]`` or ``v.value``;
    write with ``v[...] = new`` (any shape) or ``v[idx] = new``."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        if idx is Ellipsis:
            return self.value
        return self.value[idx]

    def __setitem__(self, idx, new):
        if idx is Ellipsis:
            self.value = new
        else:
            self.value = self.value.at[idx].set(new)

    def __jax_array__(self):
        return self.value

    def __getattr__(self, name):
        # shape / dtype / astype / ... of the held array
        if name == "value":
            raise AttributeError(name)
        return getattr(self.value, name)

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"


class Param(Variable):
    """A trainable variable (the `Param` filter of `split` / `state`)."""


class Module:
    """Base class of stateful modules. It adds no behaviour: state is found
    by walking the instance attributes."""


class List(list):
    """A list whose items (modules, variables, arrays) are part of the
    owner's state, keyed by position."""


class Dict(dict):
    """A dict whose values are part of the owner's state, keyed by name."""


class Rngs:
    """Seeded key stream: ``Rngs(0).params()`` returns a fresh key per call."""

    def __init__(self, seed: int = 0, **_):
        self._key = jax.random.key(seed)
        self._count = 0

    def __call__(self):
        self._count += 1
        return jax.random.fold_in(self._key, self._count)

    params = __call__


# ------------------------------------------------------------------- graph
def _is_array(v) -> bool:
    return isinstance(v, (jax.Array, np.ndarray))


def _is_node(v) -> bool:
    return isinstance(v, (Module, List, Dict))


def _children(node):
    """(key, value) pairs of a node in a fixed order."""
    if isinstance(node, List):
        return list(enumerate(node))
    if isinstance(node, Dict):
        return sorted(node.items(), key=lambda kv: str(kv[0]))
    return sorted(vars(node).items())


_RAW = "raw"   # kind of an array held directly as an attribute


@dataclasses.dataclass(frozen=True, eq=False)
class _NodeDef:
    cls: type
    index: int                      # creation order, for shared references
    static: Tuple                   # (key, value) of non-state attributes
    children: Tuple                 # (key, _NodeDef | _LeafDef | _RefDef)


@dataclasses.dataclass(frozen=True, eq=False)
class _LeafDef:
    kind: Any                       # Variable subclass or _RAW
    path: Tuple
    index: int = -1                 # a Variable's creation order


@dataclasses.dataclass(frozen=True, eq=False)
class _RefDef:
    index: int


@dataclasses.dataclass(frozen=True, eq=False)
class GraphDef:
    """Static structure of a module: what `merge` rebuilds it from."""

    root: _NodeDef


def _flatten(module) -> Tuple[GraphDef, _TList]:
    """→ (graphdef, [(path, kind, value)]) in a fixed traversal order."""
    seen: _TDict[int, int] = {}
    leaves: _TList = []

    def visit(node, path):
        if id(node) in seen:
            return _RefDef(seen[id(node)])
        index = len(seen)
        seen[id(node)] = index
        static, children = [], []
        for k, v in _children(node):
            p = path + (k,)
            if _is_node(v):
                children.append((k, visit(v, p)))
            elif isinstance(v, Variable):
                if id(v) in seen:
                    children.append((k, _RefDef(seen[id(v)])))
                    continue
                seen[id(v)] = len(seen)
                leaves.append((p, type(v), v.value))
                children.append((k, _LeafDef(type(v), p, seen[id(v)])))
            elif _is_array(v):
                leaves.append((p, _RAW, v))
                children.append((k, _LeafDef(_RAW, p)))
            else:
                static.append((k, v))
        return _NodeDef(type(node), index, tuple(static), tuple(children))

    return GraphDef(visit(module, ())), leaves


def _matches(flt, kind) -> bool:
    if flt is Ellipsis:
        return True
    if isinstance(flt, type) and issubclass(flt, Variable):
        return kind is not _RAW and issubclass(kind, flt)
    raise TypeError(f"unsupported state filter: {flt!r}")


def _nest(items) -> dict:
    out: dict = {}
    for path, value in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = value
    return out


def _partition(leaves, filters, strict: bool):
    """One nested state per filter (first match wins); with `strict`, a
    leaf no filter takes is an error (split must cover the whole state)."""
    if not filters:
        filters = (Ellipsis,)
    groups = [[] for _ in filters]
    for path, kind, value in leaves:
        for i, f in enumerate(filters):
            if _matches(f, kind):
                groups[i].append((path, value))
                break
        else:
            if strict:
                raise ValueError(
                    f"state at {path} matches no filter {filters}")
    return tuple(_nest(g) for g in groups)


def split(module, *filters):
    """→ (graphdef, state, ...): one state per filter (`Param`, `Variable`,
    or ``...`` for everything not yet taken); no filter → one state."""
    graphdef, leaves = _flatten(module)
    return (graphdef,) + _partition(leaves, filters, strict=True)


def state(module, *filters):
    """The module's state (one filter or none), or a tuple of states;
    leaves no filter takes are left out."""
    _, leaves = _flatten(module)
    parts = _partition(leaves, filters, strict=False)
    return parts[0] if len(parts) == 1 else parts


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def merge(graphdef: GraphDef, *states):
    """Build a new module from `graphdef` and states that together cover
    its whole state."""
    values = {}
    for st in states:
        values.update(_flat(st))
    built: _TDict[int, Any] = {}

    def leaf(d: _LeafDef):
        if d.path not in values:
            raise KeyError(f"merge: no state for {'/'.join(map(str, d.path))}")
        v = values[d.path]
        if d.kind is _RAW:
            return v
        var = object.__new__(d.kind)
        var.value = v
        built[d.index] = var
        return var

    def build(d):
        if isinstance(d, _RefDef):
            return built[d.index]
        if isinstance(d, _LeafDef):
            return leaf(d)
        if issubclass(d.cls, (List, Dict)):
            obj = d.cls()
            built[d.index] = obj
            items = dict(d.static)
            items.update((k, build(c)) for k, c in d.children)
            if isinstance(obj, List):
                obj.extend(items[i] for i in range(len(items)))
            else:
                obj.update(items)
            return obj
        obj = object.__new__(d.cls)
        built[d.index] = obj
        obj.__dict__.update(d.static)
        for k, c in d.children:
            obj.__dict__[k] = build(c)
        return obj

    return build(graphdef.root)


def update(module, *states):
    """Write the values of `states` into `module` in place."""
    for st in states:
        for path, value in _flat(st):
            obj = module
            for k in path[:-1]:
                obj = obj[k] if isinstance(obj, (List, Dict)) else getattr(obj, k)
            k = path[-1]
            cur = obj[k] if isinstance(obj, (List, Dict)) else getattr(obj, k)
            if isinstance(cur, Variable):
                cur.value = value
            elif isinstance(obj, (List, Dict)):
                obj[k] = value
            else:
                setattr(obj, k, value)


# --------------------------------------------------------------- dataclasses
def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves (hashable metadata)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)
