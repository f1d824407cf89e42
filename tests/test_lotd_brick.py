"""Brick-layout LoTD tests."""

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops import lotd_brick as B
from nr3d_lib_tpu.ops import lotd as L


def test_meta_and_layout():
    meta = B.make_brick_meta([16, 32, 2048], ["Dense", "Dense", "Hash"],
                             hashmap_rows=4096)
    assert meta.levels[0].bricks_per_axis == (5, 5, 5)
    assert meta.levels[0].n_rows == 125
    assert meta.levels[2].kind == "hash" and meta.levels[2].n_rows == 4096
    assert meta.levels[1].row_offset == 125
    assert meta.out_features == 6


def test_dense_brick_matches_classic_dense(rng):
    """With the brick table materialized from canonical vertex params, the
    dense brick encode must equal the classic Dense LoTD bit-for-bit."""
    res = 16
    classic = L.generate_meta(3, [res], 2, "Dense")
    vparams = jnp.asarray(rng.standard_normal(classic.n_params))

    bmeta = B.make_brick_meta([res], ["Dense"])
    table = B.materialize_dense_brick_table(vparams, bmeta.levels[0])
    assert table.shape == (bmeta.levels[0].n_rows, 128)

    x = jnp.asarray(rng.uniform(0.01, 0.99, (64, 3)))
    y_classic = L.lotd_encode(x, vparams, classic)
    y_brick = B.brick_encode_xla(x, table, bmeta)
    np.testing.assert_allclose(np.asarray(y_brick), np.asarray(y_classic),
                               rtol=1e-10, atol=1e-12)


def test_brick_encode_continuity_dense(rng):
    """Dense-from-canonical must be continuous across brick boundaries."""
    res = 16
    bmeta = B.make_brick_meta([res], ["Dense"])
    vparams = jnp.asarray(rng.standard_normal(res ** 3 * 2))
    table = B.materialize_dense_brick_table(vparams, bmeta.levels[0])
    # boundary between cells 2 and 3 (brick 0 → 1) at v = 3.5/(res-2)... walk x
    scale = res - 2
    x_b = (3.0 - 0.5) / scale  # cell boundary where cell jumps 2→3
    eps = 1e-5
    for xb in [x_b, (6.0 - 0.5) / scale]:
        xm = jnp.asarray([[xb - eps, 0.41, 0.73]])
        xp = jnp.asarray([[xb + eps, 0.41, 0.73]])
        ym = B.brick_encode_xla(xm, table, bmeta)
        yp = B.brick_encode_xla(xp, table, bmeta)
        np.testing.assert_allclose(np.asarray(ym), np.asarray(yp), atol=1e-3)


def test_grads_flow_to_canonical_params(rng):
    res = 16
    bmeta = B.make_brick_meta([res], ["Dense"])
    vparams = jnp.asarray(rng.standard_normal(res ** 3 * 2))
    x = jnp.asarray(rng.uniform(0.05, 0.95, (16, 3)))

    def loss(p):
        table = B.materialize_dense_brick_table(p, bmeta.levels[0])
        return (B.brick_encode_xla(x, table, bmeta) ** 2).sum()

    g = np.asarray(jax.grad(loss)(vparams))
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    # finite diff
    eps = 1e-6
    p0 = np.asarray(vparams)
    nz = np.nonzero(np.abs(g) > 1e-3)[0]
    for j in nz[:3]:
        pp, pm = p0.copy(), p0.copy()
        pp[j] += eps
        pm[j] -= eps
        fd = (loss(jnp.asarray(pp)) - loss(jnp.asarray(pm))) / (2 * eps)
        np.testing.assert_allclose(g[j], fd, rtol=1e-4, atol=1e-7)


def test_hash_level_basic(rng):
    bmeta = B.make_brick_meta([256], ["Hash"], hashmap_rows=512)
    table = jnp.asarray(rng.standard_normal((bmeta.total_rows, 128)) * 0.1)
    x = jnp.asarray(rng.uniform(0.01, 0.99, (32, 3)))
    y = B.brick_encode_xla(x, table, bmeta)
    assert y.shape == (32, 2)
    assert np.isfinite(np.asarray(y)).all()
    # same x twice → same features (function of position)
    y2 = B.brick_encode_xla(x, table, bmeta)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y2))
    # gradient to x exists (interpolation)
    g = jax.grad(lambda xx: B.brick_encode_xla(xx, table, bmeta).sum())(x)
    assert np.isfinite(np.asarray(g)).all()


def test_second_order_through_brick(rng):
    """Eikonal-style: grad of grad-norm wrt table must be finite/nonzero
    (plain autodiff → all orders available)."""
    bmeta = B.make_brick_meta([16], ["Dense"])
    table = jnp.asarray(rng.standard_normal((bmeta.total_rows, 128)) * 0.1)
    x = jnp.asarray(rng.uniform(0.1, 0.9, (8, 3)))

    def eik(t):
        def f(xx):
            return B.brick_encode_xla(xx, t, bmeta).sum()

        nab = jax.grad(f)(x)
        return ((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2).sum()

    g = np.asarray(jax.grad(eik)(table))
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()


def test_brick_nablas_custom_vjp_cpu(rng):
    """Eikonal loss through the nested vjp of brick_encode_xla: its
    gradient to the table matches central finite differences of the
    first-order nablas (the double backward is plain autodiff)."""
    bmeta = B.make_brick_meta([16], ["Dense"])
    table = jnp.asarray(rng.standard_normal((bmeta.total_rows, 128)) * 0.1)
    x = jnp.asarray(rng.uniform(0.1, 0.9, (16, 3)))
    g_up = jnp.asarray(rng.standard_normal((16, 2)))

    def eik(tt):
        _, vjp_fn = jax.vjp(lambda x_: B.brick_encode_xla(x_, tt, bmeta), x)
        nab = vjp_fn(g_up)[0]
        return ((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2).sum()

    g = np.asarray(jax.grad(eik)(table))
    assert np.isfinite(g).all()
    t0 = np.asarray(table)
    eps = 1e-6
    for flat in np.argsort(-np.abs(g).ravel())[:3]:
        j = np.unravel_index(flat, g.shape)
        tp, tm = t0.copy(), t0.copy()
        tp[j] += eps
        tm[j] -= eps
        fd = (eik(jnp.asarray(tp)) - eik(jnp.asarray(tm))) / (2 * eps)
        np.testing.assert_allclose(g[j], fd, rtol=1e-4, atol=1e-7)

def test_brick_sdf_field_nablas_path(rng):
    """LoTDSDF with the brick backend: forward_sdf_nablas must equal plain
    autodiff of the whole field, for both the nablas primal and the eikonal
    gradient to every parameter."""
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.fields.sdf import LoTDSDF

    f = LoTDSDF(encoding_cfg={
        "backend": "brick",
        "lotd_cfg": {"lod_res": [8, 16], "lod_types": ["Dense", "Hash"]},
        "hashmap_rows": 128},
        decoder_cfg={"D": 1, "W": 16}, n_geo_feat=4, seed=0)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (32, 3)).astype(np.float32))

    out = f.forward_sdf_nablas(x)
    nab_ref = jax.vmap(jax.grad(lambda xx: f._sdf_h(xx[None])[0, 0]))(x)
    np.testing.assert_allclose(np.asarray(out["nablas"]), np.asarray(nab_ref),
                               rtol=1e-4, atol=1e-5)
    sdf_ref = f.forward_sdf(x)
    np.testing.assert_allclose(np.asarray(out["sdf"]),
                               np.asarray(sdf_ref["sdf"]), rtol=1e-6)

    graphdef, params, rest = nn.split(f, nn.Param, ...)

    def eik(p, use_brick_path):
        m = nn.merge(graphdef, p, rest)
        if use_brick_path:
            o = m.forward_sdf_nablas(x)
            nab = o["nablas"]
        else:
            def g1(xx):
                return m._sdf_h(xx)[..., 0].sum()

            nab = jax.grad(g1)(x)
        return ((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2).sum()

    g_brick = jax.grad(lambda p: eik(p, True))(params)
    g_plain = jax.grad(lambda p: eik(p, False))(params)
    leaves_b = jax.tree_util.tree_leaves_with_path(g_brick)
    leaves_p = {jax.tree_util.keystr(k): v
                for k, v in jax.tree_util.tree_leaves_with_path(g_plain)}
    assert leaves_b
    for k, v in leaves_b:
        ref = leaves_p[jax.tree_util.keystr(k)]
        np.testing.assert_allclose(np.asarray(v), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(k))


def test_brick_encoding_module(rng):
    from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_brick_encoding import (
        LoTDBrickEncoding)

    enc = LoTDBrickEncoding(3, lod_res=[16, 128], lod_types=["Dense", "Hash"],
                            hashmap_rows=256, seed=3)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (32, 3)).astype(np.float32))
    y = enc(x)
    assert y.shape == (32, 4) and np.isfinite(np.asarray(y)).all()

    # gradient flows into both dense canonical and hash rows
    from nr3d_lib_tpu import nn

    graphdef, params, rest = nn.split(enc, nn.Param, ...)

    def loss(p):
        m = nn.merge(graphdef, p, rest)
        return (m(x) ** 2).sum()

    g = jax.tree_util.tree_leaves(jax.grad(loss)(params))[0]
    g = np.asarray(g)
    o = enc._param_offsets
    assert (np.abs(g[o[0]:o[1]]) > 0).any(), "dense level got no grad"
    assert (np.abs(g[o[1]:o[2]]) > 0).any(), "hash level got no grad"


