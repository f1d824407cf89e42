"""F=4 cell permuto (ops/permuto_cell4.py): grads, a short fit, and the
dynamic field's nablas, 3D and 4D (the dynamic-scene case)."""

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops import permuto_cell4 as P4


def test_custom_vjp_cpu_and_fit(rng):
    """Straight-through table grads equal the grads at the quantized table;
    a short fit through a linear head converges (4D — the dynamic-scene
    case)."""
    import optax

    meta = P4.make_permuto_cell4_meta(4, [3.0, 6.0, 12.0], hashmap_rows=512)
    table = jnp.asarray(rng.standard_normal((meta.total_rows, 256))
                        .astype(np.float32) * 1e-2)
    x = jnp.asarray(rng.uniform(0.0, 1.0, (2048, 4)).astype(np.float32))

    from nr3d_lib_tpu.ops.lotd_brick4 import _quantize4

    gt_tab = jax.grad(lambda tt: jnp.sum(
        P4.permuto_cell4_encode_xla(x[:64], tt, meta) ** 2))(table)
    gt_ref = jax.grad(lambda tt: jnp.sum(
        P4.permuto_cell4_encode_xla(x[:64], tt, meta) ** 2))(
            _quantize4(table))
    np.testing.assert_allclose(np.asarray(gt_tab), np.asarray(gt_ref),
                               rtol=1e-6, atol=1e-7)

    w = jnp.asarray(rng.standard_normal((4 * meta.n_levels, 1))
                    .astype(np.float32)) * 0.3
    tgt = jnp.sin(5 * x[:, :1]) * jnp.cos(3 * x[:, 3:4])

    def loss(tt):
        return jnp.mean(
            (P4.permuto_cell4_encode_xla(x, tt, meta) @ w - tgt) ** 2)

    opt = optax.adam(1e-2)
    ost = opt.init(table)
    tt = table
    l0 = float(loss(tt))

    @jax.jit
    def step(tt, ost):
        l, g = jax.value_and_grad(loss)(tt)
        u, ost = opt.update(g, ost)
        return optax.apply_updates(tt, u), ost, l

    for _ in range(150):
        tt, ost, l = step(tt, ost)
    assert float(l) < 0.5 * l0


def test_nablas4_kernel_and_dynamic_field(rng):
    """The dynamic SDF's nablas (4D x,t cell encode; spatial grads only)
    vs full autodiff, and finite eikonal grads."""
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.fields_dynamic import DynamicPermutoConcatSDF

    f = DynamicPermutoConcatSDF(
        permuto_cfg={"res_list": [3.0, 6.0], "backend": "cell",
                     "n_feats": 4, "hashmap_rows": 128},
        decoder_cfg={"D": 1, "W": 16})
    xs = jnp.asarray(rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32))
    ts = jnp.full((64,), 0.25)
    out = f.forward_sdf_nablas(xs, ts)

    def f_ref(xx):
        o = f._sdf_h(xx, ts)
        return o[..., 0], o[..., 1:]

    (sdf_ref, h_ref), vjp_fn = jax.vjp(f_ref, xs)
    nab_ref2 = vjp_fn((jnp.ones_like(sdf_ref), jnp.zeros_like(h_ref)))[0]
    np.testing.assert_allclose(np.asarray(out["sdf"]),
                               np.asarray(sdf_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["nablas"]),
                               np.asarray(nab_ref2), rtol=1e-4, atol=1e-5)

    gdef, state = nn.split(f)

    def loss(s):
        m = nn.merge(gdef, s)
        o = m.forward_sdf_nablas(xs, ts)
        return jnp.mean((jnp.linalg.norm(o["nablas"], axis=-1) - 1) ** 2)

    gr = jax.grad(loss)(state)
    assert all(bool(jnp.isfinite(v).all()) for v in jax.tree.leaves(gr))
