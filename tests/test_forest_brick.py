"""Per-block (forest/batched) brick encoding: row-offset correctness,
second order through the offsets, and the forest model's brick backend
(reference capability: csrc/lotd/lotd_forest.h; here
ops/lotd_brick.brick_encode_xla with `bidx`)."""

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops import lotd_brick as B


def _meta():
    return B.make_brick_meta([12, 24], ["Dense", "Hash"], hashmap_rows=128)


def test_batched_xla_matches_per_block(rng):
    """brick_encode_xla with bidx == running it per block with that
    block's table slice; bidx<0 clamps to block 0."""
    meta = _meta()
    n_blocks = 3
    table = jnp.asarray(rng.standard_normal(
        (n_blocks * meta.total_rows, 128)).astype(np.float32))
    x = jnp.asarray(rng.uniform(0.0, 0.999, (128, 3)).astype(np.float32))
    bidx = jnp.asarray(rng.integers(-1, n_blocks, 128).astype(np.int32))

    y = B.brick_encode_xla(x, table, meta, bidx)
    for b in range(n_blocks):
        sel = np.asarray(bidx) == b
        tb = table[b * meta.total_rows:(b + 1) * meta.total_rows]
        y_b = B.brick_encode_xla(x[sel], tb, meta)
        np.testing.assert_allclose(np.asarray(y[sel]), np.asarray(y_b),
                                   rtol=1e-6, atol=1e-7)
    # clamped negatives behave like block 0
    sel = np.asarray(bidx) < 0
    t0 = table[:meta.total_rows]
    np.testing.assert_allclose(np.asarray(y[sel]),
                               np.asarray(B.brick_encode_xla(x[sel], t0,
                                                             meta)),
                               rtol=1e-6, atol=1e-7)


def test_nablas_batched_second_order_cpu(rng):
    """Eikonal-style grads through the per-block encode's nested vjp equal
    the same loss computed block by block on each block's table slice."""
    meta = _meta()
    n_blocks = 2
    rows = meta.total_rows
    table = jnp.asarray(rng.standard_normal(
        (n_blocks * rows, 128)).astype(np.float32))
    x = jnp.asarray(rng.uniform(0.0, 0.999, (64, 3)).astype(np.float32))
    bidx_np = rng.integers(0, n_blocks, 64).astype(np.int32)
    bidx = jnp.asarray(bidx_np)
    g_up = jnp.asarray(rng.standard_normal((64, 2 * meta.n_levels))
                       .astype(np.float32))

    def eik_terms(xx, tt, gu, b=None):
        _, vjp_fn = jax.vjp(lambda x_: B.brick_encode_xla(x_, tt, meta, b),
                            xx)
        nab = vjp_fn(gu)[0]
        return (jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2

    def eik(tt):
        return jnp.sum(eik_terms(x, tt, g_up, bidx))

    def eik_blockwise(tt):
        tot = 0.0
        for b in range(n_blocks):
            sel = bidx_np == b
            tot = tot + jnp.sum(eik_terms(x[sel], tt[b * rows:(b + 1) * rows],
                                          g_up[sel]))
        return tot

    g1 = jax.grad(eik)(table)
    g2 = jax.grad(eik_blockwise)(table)
    assert (np.abs(np.asarray(g1)) > 0).any()
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-5, atol=1e-5)


def test_forest_model_brick_backend_train_step():
    """LoTDForestNeuSModel with the brick-backend encoding: render + one
    eikonal train step, loss decreases and grads stay finite."""
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel

    m = LoTDForestNeuSModel(
        space_cfg={"resolution": (2, 1, 1), "origin": (-1, 0, 0),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [6, 12], "lod_n_feats": 2,
                         "lod_types": ["Dense", "Dense"],
                         "backend": "brick"},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        n_march_steps=48)
    m.populate()
    assert m.field.implicit_surface.encoding.backend == "brick"
    graphdef, params, rest = nn.split(m, nn.Param, ...)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    o = jnp.asarray([[-2.0, 0.4, 0.4], [2.0, 0.6, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    gt = jnp.asarray([[0.2, 0.4, 0.6], [0.6, 0.4, 0.2]])

    @jax.jit
    def step(params, opt_state, key):
        def loss_fn(p):
            mm = nn.merge(graphdef, p, rest)
            r, vb = mm.ray_query(mm.ray_test(o, d), key=key)
            eik = jnp.mean((jnp.linalg.norm(vb["nablas_packed"], axis=-1)
                            - 1.0) ** 2)
            return jnp.mean((r["rgb_volume"] - gt) ** 2) + 0.01 * eik

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt_state2 = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state2, loss, g

    losses = []
    for it in range(5):
        params, opt_state, loss, g = step(params, opt_state,
                                          jax.random.key(it))
        losses.append(float(loss))
        assert all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(g))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
