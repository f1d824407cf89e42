"""Multi-device tests on the virtual 8-CPU mesh: sharded DP training,
identical results vs single-device, forest block-axis sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from nr3d_lib_tpu import nn


def test_sharded_train_step_matches_single_device():
    from nr3d_lib_tpu.parallel import make_mesh
    from nr3d_lib_tpu.parallel.train import (make_sharded_train_step,
                                             replicate, shard_rays)

    mesh = make_mesh()
    w0 = {"w": jnp.ones((3, 4)), "b": jnp.zeros(4)}
    opt = optax.sgd(0.1)

    def loss_fn(params, batch, key):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    batch = {"x": jax.random.normal(jax.random.key(0), (64, 3)),
             "y": jax.random.normal(jax.random.key(1), (64, 4))}

    # single device reference
    st = opt.init(w0)
    loss_ref, g = jax.value_and_grad(loss_fn)(w0, batch, None)
    up, _ = opt.update(g, st, w0)
    w_ref = optax.apply_updates(w0, up)

    step = make_sharded_train_step(loss_fn, opt, mesh, donate=False)
    params = replicate(w0, mesh)
    opt_state = replicate(opt.init(w0), mesh)
    sharded_batch = shard_rays(batch, mesh)
    params2, _, loss2 = step(params, opt_state, sharded_batch, None)
    assert float(loss2) == pytest.approx(float(loss_ref), rel=1e-6)
    np.testing.assert_allclose(np.asarray(params2["w"]), np.asarray(w_ref["w"]),
                               rtol=1e-6)
    # rays were actually sharded over 8 devices
    assert len(sharded_batch["x"].sharding.device_set) == 8


def test_sharded_nerf_render_consistency():
    """Full NeRF ray query sharded over rays == unsharded result."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.graphics.nerf_ray_query import nerf_ray_query_fixed
    from nr3d_lib_tpu.models.model_base import LoTDNeRFModel
    from nr3d_lib_tpu.parallel import make_mesh

    mesh = make_mesh()
    model = LoTDNeRFModel(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [8], "lod_n_feats": 2, "lod_types": "Dense"}},
            "density_decoder_cfg": {"D": 1, "W": 8},
            "radiance_cfg": {"D": 1, "W": 8}})
    graphdef, state = nn.split(model)

    def render(state, o, d):
        m = nn.merge(graphdef, state)
        rt = m.space.ray_test(o, d)
        rendered, _ = nerf_ray_query_fixed(m, m.space, rt, n_samples=16)
        return rendered["rgb_volume"]

    o = jax.random.normal(jax.random.key(0), (32, 3)) * 2
    d = -o / jnp.linalg.norm(o, axis=-1, keepdims=True)
    ref = render(state, o, d)

    f = jax.jit(render, in_shardings=(NamedSharding(mesh, P()),
                                      NamedSharding(mesh, P("data")),
                                      NamedSharding(mesh, P("data"))),
                out_shardings=NamedSharding(mesh, P("data")))
    out = f(jax.device_put(state, NamedSharding(mesh, P())),
            jax.device_put(o, NamedSharding(mesh, P("data"))),
            jax.device_put(d, NamedSharding(mesh, P("data"))))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_forest_block_axis_sharding():
    """Forest per-block params shard over the 'block' mesh axis; batched
    encode still computes correctly."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.ops import lotd as L
    from nr3d_lib_tpu.parallel import make_mesh

    mesh = make_mesh([2, 4], ("data", "block"))
    meta = L.generate_meta(3, [6], 2, "Dense")
    n_blocks = 8
    params = jax.random.normal(jax.random.key(0), (n_blocks, meta.n_params))
    x = jax.random.uniform(jax.random.key(1), (64, 3))
    bidx = jax.random.randint(jax.random.key(2), (64,), 0, n_blocks)
    ref = L.lotd_encode(x, params, meta, bidx=bidx)

    # params sharded over block axis, rays over data axis
    p_sh = jax.device_put(params, NamedSharding(mesh, P("block", None)))
    x_sh = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    b_sh = jax.device_put(bidx, NamedSharding(mesh, P("data")))
    f = jax.jit(lambda xx, pp, bb: L.lotd_encode(xx, pp, meta, bidx=bb))
    out = f(x_sh, p_sh, b_sh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5)


def test_graft_entry_dryrun():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_table_parallel_brick_encode():
    """Table-parallel encode (nr3d_lib_tpu/parallel/table_parallel.py):
    the hash/dense table row-sharded over a 'model' axis on a 2D DP×TP
    mesh must match the single-table XLA encode exactly, and gradients
    must flow to the sharded table (each row's grad on its owning shard)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.ops import lotd_brick as B
    from nr3d_lib_tpu.parallel.table_parallel import (
        brick_encode_table_sharded, pad_table_for_sharding)

    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("data", "model"))

    meta = B.make_brick_meta([16, 32, 256], ["Dense", "Dense", "Hash"],
                             hashmap_rows=512)
    rng = np.random.default_rng(3)
    table = jnp.asarray(rng.standard_normal((meta.total_rows, 128))
                        .astype(np.float32) * 0.1)
    x = jnp.asarray(rng.uniform(0.01, 0.99, (256, 3)).astype(np.float32))

    t_pad = pad_table_for_sharding(table, 4)
    t_sh = jax.device_put(t_pad, NamedSharding(mesh, P("model")))
    x_sh = jax.device_put(x, NamedSharding(mesh, P("data")))

    y = jax.jit(lambda xx, tt: brick_encode_table_sharded(
        xx, tt, meta, mesh, "model", "data"))(x_sh, t_sh)
    y_ref = B.brick_encode_xla(x, table, meta)
    # psum reassociates the per-shard partial sums → ~1e-6 float drift
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-4, atol=2e-6)

    # gradients: dtable through the sharded path == dtable through XLA
    def loss_sh(tt):
        return jnp.sum(brick_encode_table_sharded(
            x_sh, tt, meta, mesh, "model", "data") ** 2)

    def loss_ref(tt):
        return jnp.sum(B.brick_encode_xla(x, tt, meta) ** 2)

    g_sh = jax.jit(jax.grad(loss_sh))(t_sh)
    g_ref = jax.grad(loss_ref)(table)
    np.testing.assert_allclose(np.asarray(g_sh)[:meta.total_rows],
                               np.asarray(g_ref), rtol=1e-5, atol=1e-6)
    # grad stays sharded over the model axis (no table all-gather)
    assert g_sh.sharding.spec == P("model")


def test_pipeline_parallel_stages():
    """pipeline_apply (nr3d_lib_tpu/parallel/pipeline.py): a 4-stage
    linear-chain pipeline over a 'stage' mesh axis must equal applying the
    stages sequentially, and must be differentiable wrt the sharded stage
    params."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.parallel.pipeline import pipeline_apply

    n_stage, n_micro, b, f = 4, 6, 8, 16
    devs = np.asarray(jax.devices()[:n_stage])
    mesh = Mesh(devs, ("stage",))

    rng = np.random.default_rng(0)
    ws = jnp.asarray(rng.standard_normal((n_stage, f, f))
                     .astype(np.float32) * 0.3)
    xs = jnp.asarray(rng.standard_normal((n_micro, b, f)).astype(np.float32))

    def stage_fn(w, h):
        return jnp.tanh(h @ w)

    ws_sh = jax.device_put(ws, NamedSharding(mesh, P("stage")))
    y = jax.jit(lambda w, x: pipeline_apply(stage_fn, w, x, mesh))(ws_sh, xs)

    # sequential reference
    h = xs
    for s in range(n_stage):
        h = jnp.tanh(h @ ws[s])
    np.testing.assert_allclose(np.asarray(y), np.asarray(h),
                               rtol=1e-5, atol=1e-6)

    # grads flow to every stage's params
    def loss(w):
        return jnp.sum(pipeline_apply(stage_fn, w, xs, mesh) ** 2)

    g = jax.jit(jax.grad(loss))(ws_sh)
    gn = np.linalg.norm(np.asarray(g).reshape(n_stage, -1), axis=-1)
    assert (gn > 0).all(), gn
    ref_g = jax.grad(lambda w: jnp.sum(
        _seq_apply(w, xs) ** 2))(ws)
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref_g),
                               rtol=1e-4, atol=1e-5)


def _seq_apply(ws, xs):
    h = xs
    for s in range(ws.shape[0]):
        h = jnp.tanh(h @ ws[s])
    return h


def test_forest_block_sharded_encode_and_train_step():
    """Explicit shard_map forest placement (parallel/forest_parallel.py):
    per-block params live on the owning device, one psum over the block
    axis reconstructs features exactly; a 2D DP×block-MP train step
    matches the single-device step and keeps block params/grads sharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.ops import lotd as L
    from nr3d_lib_tpu.parallel import make_mesh
    from nr3d_lib_tpu.parallel.forest_parallel import (
        forest_encode_block_sharded, make_forest_sharded_train_step,
        pad_blocks_for_sharding)

    mesh = make_mesh([2, 4], ("data", "block"))
    meta = L.generate_meta(3, [4, 6], 2, "Dense")
    n_blocks = 7                               # deliberately not divisible
    params_b = 0.1 * jax.random.normal(jax.random.key(0),
                                       (n_blocks, meta.n_params))
    params_b = pad_blocks_for_sharding(params_b, 4)
    assert params_b.shape[0] == 8
    x = jax.random.uniform(jax.random.key(1), (64, 3))
    bidx = jax.random.randint(jax.random.key(2), (64,), -1, n_blocks)

    ref = L.lotd_encode(x, params_b, meta, bidx=bidx)
    p_sh = jax.device_put(params_b, NamedSharding(mesh, P("block", None)))
    x_sh = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    b_sh = jax.device_put(bidx, NamedSharding(mesh, P("data")))
    out = forest_encode_block_sharded(x_sh, b_sh, p_sh, meta, mesh,
                                      data_axis="data")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)

    # ---- one DP×MP train step vs single-device reference
    w = 0.01 * jax.random.normal(jax.random.key(3), (meta.n_encoded_dims
                                 if hasattr(meta, "n_encoded_dims")
                                 else ref.shape[-1], 1))
    tgt = jax.random.normal(jax.random.key(4), (64, 1))
    opt = optax.sgd(0.5)

    def loss_fn(other, feats, batch):
        return jnp.mean((feats @ other - batch["tgt"]) ** 2)

    params0 = {"blocks": params_b, "other": w}

    def single_loss(p):
        feats = L.lotd_encode(x, p["blocks"], meta, bidx=bidx)
        return loss_fn(p["other"], feats, {"tgt": tgt})

    g_ref = jax.grad(single_loss)(params0)
    upd_ref, _ = opt.update(g_ref, opt.init(params0), params0)
    p_ref = optax.apply_updates(params0, upd_ref)

    step = make_forest_sharded_train_step(loss_fn, opt, meta, mesh)
    params_sh = {"blocks": p_sh,
                 "other": jax.device_put(w, NamedSharding(mesh, P()))}
    batch = {"x": x_sh, "bidx": b_sh,
             "tgt": jax.device_put(tgt, NamedSharding(mesh, P("data", None)))}
    p1, _, loss1 = step(params_sh, opt.init(params_sh), batch, None)
    np.testing.assert_allclose(float(loss1), float(single_loss(params0)),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p1["blocks"]),
                               np.asarray(p_ref["blocks"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p1["other"]),
                               np.asarray(p_ref["other"]),
                               rtol=1e-4, atol=1e-6)
    # block params must STAY sharded over the block axis after the step
    spec = p1["blocks"].sharding.spec
    assert spec and spec[0] == "block", f"blocks lost sharding: {spec}"


def test_sharded_checkpoint_roundtrip(tmp_path):
    """orbax-backed sharded save/restore (checkpoint_sharded.py): shards
    land back on the requested sharding without a host gather, including
    restoring onto a DIFFERENT layout than the save used."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.checkpoint_sharded import (abstract_like, load_sharded,
                                                 save_sharded)
    from nr3d_lib_tpu.parallel import make_mesh

    mesh = make_mesh([2, 4], ("data", "block"))
    blocks = jax.device_put(
        jax.random.normal(jax.random.key(0), (8, 32)),
        NamedSharding(mesh, P("block", None)))
    mlp = jax.device_put(jax.random.normal(jax.random.key(1), (16, 4)),
                         NamedSharding(mesh, P()))
    state = {"blocks": blocks, "mlp": mlp}
    path = save_sharded(str(tmp_path / "step_10"), state)

    # same-layout restore
    back = load_sharded(path, state)
    np.testing.assert_array_equal(np.asarray(back["blocks"]),
                                  np.asarray(blocks))
    assert back["blocks"].sharding.spec == P("block", None)

    # reshard on load: blocks now over the data axis
    tmpl = {"blocks": jax.ShapeDtypeStruct(
        blocks.shape, blocks.dtype,
        sharding=NamedSharding(mesh, P("data", None))),
        "mlp": abstract_like(mlp)}
    re = load_sharded(path, tmpl)
    np.testing.assert_array_equal(np.asarray(re["blocks"]),
                                  np.asarray(blocks))
    assert re["blocks"].sharding.spec == P("data", None)
