"""F=4 brick encoding (ops/lotd_brick4.py): packing round-trip, dense
materialization, straight-through quantization and the module."""

import jax
import jax.numpy as jnp
import numpy as np

from nr3d_lib_tpu.ops import lotd as L
from nr3d_lib_tpu.ops import lotd_brick4 as B4


def _meta():
    return B4.make_brick4_meta([16, 32, 64, 128],
                               ["Dense", "Dense", "Hash", "Hash"],
                               hashmap_rows=512)


def test_pack_roundtrip(rng):
    """pack → in-kernel-style unpack (host arithmetic) is exactly the bf16
    quantization of the unpacked table."""
    t = jnp.asarray(rng.standard_normal((32, 256)).astype(np.float32))
    packed = B4.pack_table4(t)
    assert packed.shape == (32, 128)
    u = jax.lax.bitcast_convert_type(packed, jnp.uint32)
    lo = jax.lax.bitcast_convert_type(u << 16, jnp.float32)
    hi = jax.lax.bitcast_convert_type(u & jnp.uint32(0xFFFF0000),
                                      jnp.float32)
    tq = np.asarray(B4._quantize4(t)).reshape(32, 64, 2, 2)
    np.testing.assert_array_equal(np.asarray(lo).reshape(32, 64, 2),
                                  tq[..., 0])
    np.testing.assert_array_equal(np.asarray(hi).reshape(32, 64, 2),
                                  tq[..., 1])


def test_dense_materialization_matches_classic(rng):
    """F=4 dense-from-canonical equals the classic Dense LoTD with 4 feats
    (up to the packed path's bf16 quantization, which this XLA-side check
    does not apply)."""
    res = 16
    classic = L.generate_meta(3, [res], 4, "Dense")
    vparams = jnp.asarray(rng.standard_normal(classic.n_params)
                          .astype(np.float32))
    meta = B4.make_brick4_meta([res], ["Dense"])
    table = B4.materialize_dense_brick4(vparams, meta.levels[0])
    assert table.shape == (meta.levels[0].n_rows, 256)

    x = jnp.asarray(rng.uniform(0.01, 0.99, (128, 3)).astype(np.float32))
    y_classic = L.lotd_encode(x, vparams, classic)
    # reference comparison must quantize the same way the packed path does
    y4 = B4.brick4_encode_xla(x, table, meta)
    y_classic_q = L.lotd_encode(
        x, B4._quantize4(vparams), classic)
    np.testing.assert_allclose(np.asarray(y4), np.asarray(y_classic_q),
                               rtol=1e-5, atol=1e-6)
    # and stays close to the unquantized classic (bf16 has ~3 decimal digits)
    assert float(jnp.max(jnp.abs(y4 - y_classic))) < 3e-2


def test_custom_vjp_cpu_path(rng):
    """brick4_encode_xla quantizes straight-through: its table gradient is
    the gradient of the same encode on the pre-quantized table (cotangents
    are not rounded to bf16), and its x gradient matches too."""
    meta = B4.make_brick4_meta([16, 64], ["Dense", "Hash"], hashmap_rows=256)
    table = jnp.asarray(rng.standard_normal((meta.total_rows, 256))
                        .astype(np.float32))
    x = jnp.asarray(rng.uniform(0.0, 0.999, (64, 3)).astype(np.float32))
    tq = jax.lax.stop_gradient(B4._quantize4(table))

    def loss(tt, xx):
        return jnp.sum(B4.brick4_encode_xla(xx, tt, meta) ** 2)

    gt, gx = jax.grad(loss, argnums=(0, 1))(table, x)
    gt_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(tq, x)
    np.testing.assert_allclose(np.asarray(gt), np.asarray(gt_ref),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_ref),
                               rtol=1e-6, atol=1e-6)
    # the cotangents are full precision: not representable in bf16
    g = np.asarray(gt)[np.asarray(gt) != 0]
    assert (g != g.astype(jnp.bfloat16).astype(np.float32)).any()

def test_encoding_module_f4(rng):
    """LoTDBrickEncoding(n_feats=4): shapes, gradients to canonical params
    (dense vertices stay tied), and a quick fit through the public module."""
    import optax
    from nr3d_lib_tpu import nn

    from nr3d_lib_tpu.models.grid_encodings.lotd.lotd_brick_encoding import (
        LoTDBrickEncoding)

    enc = LoTDBrickEncoding(lod_res=[8, 16, 32], n_feats=4,
                            lod_types=["Dense", "Dense", "Hash"],
                            hashmap_rows=256)
    assert enc.out_features == 12
    x = jnp.asarray(rng.uniform(-0.99, 0.99, (256, 3)).astype(np.float32))
    y = enc(x)
    assert y.shape == (256, 12) and np.isfinite(np.asarray(y)).all()

    gdef, state = nn.split(enc)
    tgt = jnp.sin(jnp.sum(x * 4.0, -1, keepdims=True))
    w = jnp.asarray(rng.standard_normal((12, 1)).astype(np.float32)) * 0.5

    def loss_s(s):
        m = nn.merge(gdef, s)
        return jnp.mean((m(x) @ w - tgt) ** 2)

    opt = optax.adam(2e-2)
    ost = opt.init(state)

    @jax.jit
    def step(s, o):
        l, g = jax.value_and_grad(loss_s)(s)
        u, o = opt.update(g, o)
        return jax.tree.map(lambda a, b: a + b, s, u), o, l

    l0 = float(loss_s(state))
    for _ in range(150):
        state, ost, l = step(state, ost)
    assert float(l) < 0.5 * l0


def test_nablas4_custom_vjp_cpu(rng):
    """Eikonal loss through the nested vjp of the F=4 dense brick encode:
    its gradient to the canonical vertex params equals the same loss
    through the classic Dense LoTD on the bf16-quantized params."""
    res = 16
    classic = L.generate_meta(3, [res], 4, "Dense")
    meta = B4.make_brick4_meta([res], ["Dense"])
    vparams = jnp.asarray(rng.standard_normal(classic.n_params)
                          .astype(np.float32))
    x = jnp.asarray(rng.uniform(0.05, 0.95, (64, 3)).astype(np.float32))
    g_up = jnp.asarray(rng.standard_normal((64, 4)).astype(np.float32))

    def eik(enc, p):
        _, vjp_fn = jax.vjp(lambda x_: enc(x_, p), x)
        nab = vjp_fn(g_up)[0]
        return jnp.mean((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2)

    def brick(x_, p):
        return B4.brick4_encode_xla(
            x_, B4.materialize_dense_brick4(p, meta.levels[0]), meta)

    def plain(x_, p):
        return L.lotd_encode(x_, B4._quantize4(p), classic)

    g_b = jax.grad(lambda p: eik(brick, p))(vparams)
    g_c = jax.grad(lambda p: eik(plain, p))(vparams)
    assert (np.abs(np.asarray(g_b)) > 0).any()
    np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_c),
                               rtol=1e-4, atol=1e-6)
