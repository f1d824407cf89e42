"""The in-repo module system (nr3d_lib_tpu/nn.py) and .npz checkpoints."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nr3d_lib_tpu import nn


class _Leaf(nn.Module):
    def __init__(self, seed=0):
        self.w = nn.Param(jnp.full((2, 3), float(seed)))
        self.count = nn.Variable(jnp.zeros((), jnp.int32))
        self.raw = jnp.arange(4)            # bare array: state, not Param
        self.name = f"leaf{seed}"           # static


class _Tree(nn.Module):
    def __init__(self):
        self.a = _Leaf(1)
        self.alias = self.a                 # shared sub-module
        self.items = nn.List([_Leaf(2), nn.Param(jnp.ones(1))])
        self.table = nn.Dict(x=_Leaf(3))
        self.scale = 0.5


def test_split_merge_roundtrip_param_filter():
    """split(m, Param, ...) partitions state by kind; merge rebuilds an
    equal module (static attrs, containers and sharing included) that is
    a new object."""
    m = _Tree()
    graphdef, params, rest = nn.split(m, nn.Param, ...)
    assert set(params) == {"a", "items", "table"}
    assert set(params["a"]) == {"w"} and set(rest["a"]) == {"count", "raw"}
    assert params["items"][1].shape == (1,)
    assert "alias" not in params and "alias" not in rest  # stored once
    m2 = nn.merge(graphdef, params, rest)
    assert m2 is not m and m2.a is not m.a
    assert m2.alias is m2.a
    assert isinstance(m2.items, nn.List) and isinstance(m2.table, nn.Dict)
    assert m2.scale == 0.5 and m2.table["x"].name == "leaf3"
    np.testing.assert_array_equal(np.asarray(m2.items[0].w[...]),
                                  np.full((2, 3), 2.0))
    np.testing.assert_array_equal(np.asarray(m2.a.raw), np.arange(4))
    # no filter: one state holding everything
    g1, everything = nn.split(m)
    assert set(everything["a"]) == {"w", "count", "raw"}
    with pytest.raises(KeyError):
        nn.merge(graphdef, params)          # rest missing


def test_state_update_and_variable_writes():
    m = _Tree()
    p = nn.state(m, nn.Param)
    p2 = jax.tree.map(lambda x: x + 1.0, p)
    nn.update(m, p2)
    np.testing.assert_array_equal(np.asarray(m.a.w[...]), np.full((2, 3), 2.0))
    assert float(m.items[1][...][0]) == 2.0
    params, rest = nn.state(m, nn.Param, ...)
    assert "count" in rest["a"] and "w" in params["a"]
    m.a.count[...] = m.a.count[...] + 3             # whole-value write
    m.a.w[0] = jnp.zeros(3)                          # indexed write
    assert int(m.a.count.value) == 3
    np.testing.assert_array_equal(np.asarray(m.a.w[...][0]), np.zeros(3))
    assert m.a.w.shape == (2, 3) and m.a.w.dtype == m.a.w.value.dtype
    np.testing.assert_allclose(np.asarray(m.a.w[...] * 2.0), 2 * np.asarray(m.a.w[...]))


def test_merged_module_under_jit_and_grad():
    """The train-step pattern: merge inside a jitted loss, differentiate
    wrt the Param state, carry mutated non-Param state back out."""
    m = _Tree()
    graphdef, params, rest = nn.split(m, nn.Param, ...)

    @jax.jit
    def step(p, r):
        def loss(pp):
            mm = nn.merge(graphdef, pp, r)
            return jnp.sum(mm.a.w[...] ** 2) + jnp.sum(mm.items[1][...])

        g = jax.grad(loss)(p)
        mm = nn.merge(graphdef, p, r)
        mm.a.count[...] = mm.a.count[...] + 1
        _, _, r2 = nn.split(mm, nn.Param, ...)
        return g, r2

    g, rest2 = step(params, rest)
    np.testing.assert_allclose(np.asarray(g["a"]["w"]), np.full((2, 3), 2.0))
    np.testing.assert_allclose(np.asarray(g["items"][1]), [1.0])
    assert int(rest2["a"]["count"]) == 1
    assert jax.tree.structure(g) == jax.tree.structure(params)


def test_rngs_stream():
    r = nn.Rngs(3)
    k1, k2 = r.params(), r.params()
    assert not np.array_equal(jax.random.key_data(k1), jax.random.key_data(k2))
    r2 = nn.Rngs(3)
    np.testing.assert_array_equal(jax.random.key_data(r2.params()),
                                  jax.random.key_data(k1))


def test_pytree_dataclass():
    @nn.pytree_dataclass
    class Box:
        lo: jax.Array
        hi: jax.Array
        tag: int = nn.static_field(default=7)

    b = Box(jnp.zeros(3), jnp.ones(3))
    leaves, treedef = jax.tree.flatten(b)
    assert len(leaves) == 2                          # tag is static
    b2 = jax.jit(lambda x: x.replace(hi=x.hi * 2))(b)
    assert isinstance(b2, Box) and b2.tag == 7
    np.testing.assert_array_equal(np.asarray(b2.hi), 2 * np.ones(3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.lo = jnp.ones(3)


def test_npz_checkpoint_roundtrip(tmp_path):
    """CheckpointIO writes one .npz (nested keys joined by '/', list
    positions restored as ints) and restores modules via nn.update."""
    from nr3d_lib_tpu.checkpoint import CheckpointIO, sorted_ckpts

    m1 = _Tree()
    nn.update(m1, jax.tree.map(lambda x: x * 3.0, nn.state(m1, nn.Param)))
    io = CheckpointIO(str(tmp_path))
    io.register_modules(model=m1, raw={"v": jnp.arange(3.0)})
    path = io.save("ckpt_5.npz", it=5, note="x")
    with np.load(path) as z:
        assert "model/items/1" in z.files and "__extras__/it" in z.files

    m2 = _Tree()
    io2 = CheckpointIO(str(tmp_path))
    io2.register_modules(model=m2, raw={"v": jnp.zeros(3)})
    extras = io2.load("ckpt_5.npz")
    assert extras == {"it": 5, "note": "x"}
    for a, b in zip(jax.tree.leaves(nn.state(m2)), jax.tree.leaves(nn.state(m1))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(io2.module_dict["raw"]["v"]),
                                  np.arange(3.0))
    assert sorted_ckpts(str(tmp_path))[-1].endswith("ckpt_5.npz")
