"""Cell-packed permuto encoding (ops/permuto_cell.py — the brick trick
applied to the simplex lattice; reference csrc/permuto kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nr3d_lib_tpu.ops import permuto_cell as PC


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _meta(d=3, res=(4.0, 8.0, 16.0), rows=512):
    return PC.make_permuto_cell_meta(d, list(res), hashmap_rows=rows)


def test_layout_invariants():
    for d in (2, 3, 4):
        meta = PC.make_permuto_cell_meta(d, [4.0, 8.0], hashmap_rows=64)
        assert meta.n_slots == 2 ** (d + 1)
        assert meta.cells_per_row * meta.n_slots * PC.N_FEAT == PC.LANES
        assert meta.stride >= (d + 1) * PC.N_FEAT
        assert meta.vp * PC.N_FEAT == meta.stride


def test_xla_encode_continuity(rng):
    """The encode must be continuous across simplex boundaries: two nearby
    points straddling a boundary give nearby outputs (barycentric weights
    of exiting vertices → 0 at the face)."""
    meta = _meta()
    table = jnp.asarray(rng.standard_normal((meta.total_rows, 128))
                        .astype(np.float32))
    x0 = jnp.asarray(rng.uniform(0.05, 0.95, (256, 3)).astype(np.float32))
    eps = 5e-6
    dx = jnp.asarray(rng.standard_normal((256, 3)).astype(np.float32)) * eps
    y0 = PC.permuto_cell_encode_xla(x0, table, meta)
    y1 = PC.permuto_cell_encode_xla(x0 + dx, table, meta)
    # max lattice scale 16: feature Lipschitz ~ scale·|table|; 5e-6 step
    # must move outputs by ≪ 1e-2
    assert float(jnp.max(jnp.abs(y1 - y0))) < 1e-2


def test_custom_vjp_cpu_matches_autodiff(rng):
    """PermutoParams(backend='cell') wires the cell encode: values and
    grads to (x, table) equal plain autodiff of permuto_cell_encode_xla,
    and batch dims are restored."""
    from nr3d_lib_tpu.models.grid_encodings.permuto.permuto_encoding import (
        PermutoParams)

    bank = PermutoParams(3, [3.0, 7.0], backend="cell", hashmap_rows=128)
    meta = bank.meta
    table = jnp.asarray(rng.standard_normal((meta.total_rows, 128))
                        .astype(np.float32) * 0.1)
    bank.flattened_params[...] = table
    x = jnp.asarray(rng.uniform(0.1, 0.9, (4, 16, 3)).astype(np.float32))
    y = bank.encode(x)
    assert y.shape == (4, 16, meta.out_features)

    def loss_m(xx, tt):
        bank.flattened_params[...] = tt
        return jnp.sum(bank.encode(xx) ** 2)

    def loss_p(xx, tt):
        return jnp.sum(PC.permuto_cell_encode_xla(
            xx.reshape(-1, 3), tt, meta) ** 2)

    gm = jax.grad(loss_m, argnums=(0, 1))(x, table)
    gp = jax.grad(loss_p, argnums=(0, 1))(x, table)
    for a, b in zip(gm, gp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_fit_quality_vs_classic_permuto(rng):
    """Cell-local vertex copies change hash-collision structure, not
    expressive power: fitting a smooth 3D target with the same budget must
    reach a loss in the same ballpark as the classic permuto encode."""
    import optax

    from nr3d_lib_tpu.ops import permuto as P

    def target(x):
        return (jnp.sin(3.0 * x[..., 0]) * jnp.cos(5.0 * x[..., 1])
                + jnp.sin(4.0 * x[..., 2]))[..., None]

    xs = jnp.asarray(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    ys = target(xs)

    def fit(encode, params, n_iter=150):
        w = jnp.asarray(rng.standard_normal((8, 1)).astype(np.float32)) * 0.1
        opt = optax.adam(3e-2)
        st = opt.init((params, w))

        def loss(pw):
            p, ww = pw
            return jnp.mean((encode(xs, p) @ ww - ys) ** 2)

        @jax.jit
        def step(pw, st):
            l, g = jax.value_and_grad(loss)(pw)
            up, st = opt.update(g, st)
            return optax.apply_updates(pw, up), st, l

        pw = (params, w)
        for _ in range(n_iter):
            pw, st, l = step(pw, st)
        return float(l)

    res = [8.0, 16.0, 32.0, 64.0]
    cmeta = PC.make_permuto_cell_meta(3, res, hashmap_rows=512)
    ctab = jnp.asarray(rng.standard_normal(
        (cmeta.total_rows, 128)).astype(np.float32)) * 1e-3
    l_cell = fit(lambda x, p: PC.permuto_cell_encode_xla(x, p, cmeta), ctab)

    pmeta = P.make_permuto_meta(3, res, n_feats=2, log2_hashmap_size=14)
    ptab = jnp.asarray(rng.standard_normal(
        (pmeta.n_params,)).astype(np.float32)) * 1e-3
    l_classic = fit(lambda x, p: P.permuto_encode(x, p, pmeta), ptab)

    assert l_cell < max(3.0 * l_classic, 1e-3), (l_cell, l_classic)


def test_auto_dense_levels(rng):
    """Coarse levels become collision-free dense (bijective box index) with
    fewer rows; fine levels stay hashed at the full hashmap size."""
    meta = PC.make_permuto_cell_meta(3, [4.0, 8.0, 512.0], hashmap_rows=4096)
    kinds = [lev.kind for lev in meta.levels]
    assert kinds[0] == "dense" and kinds[-1] == "hash"
    assert meta.levels[0].n_rows < meta.levels[1].n_rows < 4096
    assert meta.levels[-1].n_rows == 4096

    # bijectivity on a dense level: distinct cells (k-tuples) ⇒ distinct
    # (row, lane-base) slots — the collision-freedom claim
    level = meta.levels[1]
    x = jnp.asarray(rng.uniform(0.0, 1.0, (4096, 3)).astype(np.float32))
    from nr3d_lib_tpu.ops.permuto import _simplex_parts
    rem0, _, _ = _simplex_parts(x * jnp.asarray(level.scale), 3)
    k = np.asarray(rem0).astype(np.int64) // 4                 # [N, 4]
    row, lane, _, _ = PC._level_rows_lanes_bary(x, level, meta)
    slot = np.asarray(row).astype(np.int64) * 1000000 + np.asarray(
        lane[:, 0])                                            # cell slot id
    key = (k[:, 0] + 4096) * (1 << 26) + (k[:, 1] + 4096) * (1 << 13) \
        + (k[:, 2] + 4096)
    pairs = {}
    for kk, ss in zip(key.tolist(), slot.tolist()):
        assert pairs.setdefault(kk, ss) == ss            # same cell→same slot
    inv = {}
    for kk, ss in pairs.items():
        assert inv.setdefault(ss, kk) == kk              # injective

    # in-box: every reachable k coordinate lies inside the stored box
    for i in range(3):
        assert k[:, i].min() >= level.box_lo[i]
        assert k[:, i].max() < level.box_lo[i] + level.box_dims[i]

    # encode still matches the XLA reference through the kernel
    table = jnp.asarray(rng.standard_normal((meta.total_rows, 128))
                        .astype(np.float32))
    y = PC.permuto_cell_encode_xla(x[:64], table, meta)
    assert np.isfinite(np.asarray(y)).all()


def test_sdf_cell_nablas_split(rng):
    """PermutoSDF(cell backend): forward_sdf_nablas matches full autodiff
    of the field, and eikonal grads stay finite (the training usage)."""
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.fields.sdf import PermutoSDF

    f = PermutoSDF(permuto_cfg={"res_list": [3.0, 7.0], "backend": "cell",
                                "hashmap_rows": 128},
                   decoder_cfg={"D": 1, "W": 16}, radius_init=0.5)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (128, 3)).astype(np.float32))
    out = f.forward_sdf_nablas(x)

    def f_ref(xx):
        o = f._sdf_h(xx)
        return o[..., 0], o[..., 1:]

    (sdf_ref, h_ref), vjp_fn = jax.vjp(f_ref, x)
    nab_ref = vjp_fn((jnp.ones_like(sdf_ref), jnp.zeros_like(h_ref)))[0]
    np.testing.assert_allclose(np.asarray(out["sdf"]), np.asarray(sdf_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["nablas"]),
                               np.asarray(nab_ref), rtol=1e-4, atol=1e-5)

    gdef, state = nn.split(f)

    def loss(s):
        m = nn.merge(gdef, s)
        o = m.forward_sdf_nablas(x)
        return jnp.mean((jnp.linalg.norm(o["nablas"], axis=-1) - 1) ** 2) \
            + jnp.mean(o["sdf"] ** 2)

    g = jax.grad(loss)(state)
    assert all(bool(jnp.isfinite(v).all()) for v in jax.tree.leaves(g))
