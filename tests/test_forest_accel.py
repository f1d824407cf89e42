"""Forest acceleration: per-block occupancy, empty-block skipping, sharded
forest training (VERDICT round-1 item #3; reference:
occgrid_accel/forest.py:37, csrc/occ_grid/src/forest_marching.cu:27,
fields_forest/neus/renderer_mixin.py:274)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
from nr3d_lib_tpu import nn


def _two_block_model(**kw):
    from nr3d_lib_tpu.models.fields_forest import LoTDForestNeuSModel

    m = LoTDForestNeuSModel(
        space_cfg={"resolution": (2, 2, 2), "origin": (-1, -1, -1),
                   "block_size": 1.0},
        field_cfg={"surface_cfg": {
            "lotd_cfg": {"lod_res": [6], "lod_n_feats": 2,
                         "lod_types": "Dense"},
            "decoder_cfg": {"D": 1, "W": 16}},
            "radiance_cfg": {"D": 1, "W": 16}},
        n_march_steps=64, **kw)
    return m


def test_forest_accel_query_and_march():
    from nr3d_lib_tpu.models.accelerations.occgrid_forest import (
        OccGridAccelForest)
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    sp = ForestBlockSpace(resolution=(2, 1, 1), origin=(-1.0, 0.0, 0.0),
                          block_size=1.0)
    sp.populate_from_corners(np.asarray([[0, 0, 0], [1, 0, 0]]))
    accel = OccGridAccelForest(sp, resolution=(4, 4, 4))
    # occupy only block 0's cells (block 1 fully empty)
    occ_vals = np.zeros((2, 4, 4, 4), np.float32)
    occ_vals[0] = 1.0
    accel.occ.val_grid[...] = jnp.asarray(occ_vals)

    # points: one in block 0, one in block 1, one outside
    x = jnp.asarray([[-0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [3.0, 0.5, 0.5]])
    occ = np.asarray(accel.query(x))
    assert occ[0] and not occ[1] and not occ[2]

    # ray through both blocks: only block-0 samples survive
    o = jnp.asarray([[-2.0, 0.5, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    rt = sp.ray_test(o, d)
    t, dt, bidx, mask = accel.ray_march(o, d, rt["near"], rt["far"])
    xs = np.asarray(o[0, 0] + d[0, 0] * t[0])
    m = np.asarray(mask[0])
    assert m.any()
    assert (xs[m] < 0.0).all(), "samples in the empty block must be masked"


def test_forest_empty_block_skipping_reduces_samples():
    """VERDICT #3 'done' criterion: sample counts drop with empty blocks."""
    m_full = _two_block_model()
    m_sparse = _two_block_model()
    # sparse: keep only one of the 8 blocks' occupancy
    v = np.zeros(np.asarray(m_sparse.accel.occ.val_grid[...]).shape, np.float32)
    v[0] = 1.0
    m_sparse.accel.occ.val_grid[...] = jnp.asarray(v)

    o = jnp.asarray([[-2.0, -0.5, -0.5], [2.0, 0.5, 0.5], [-2.0, 0.4, 0.4]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    rt = m_full.ray_test(o, d)
    _, vb_full = m_full.ray_query(rt)
    _, vb_sparse = m_sparse.ray_query(rt)
    n_full, n_sparse = int(vb_full["n_marched"]), int(vb_sparse["n_marched"])
    assert n_sparse < n_full * 0.5, (n_sparse, n_full)


def test_forest_model_train_step_with_accel():
    m = _two_block_model()
    m.populate()
    graphdef, params, rest = nn.split(m, nn.Param, ...)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    o = jnp.asarray([[-2.0, 0.1, 0.1], [2.0, 0.3, -0.2]])
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
        return optax.apply_updates(params, upd), opt_state2, loss

    losses = []
    for it in range(5):
        m2 = nn.merge(graphdef, params, rest)
        m2.training_before_per_step(it, jax.random.key(100 + it))
        _, _, rest = nn.split(m2, nn.Param, ...)
        params, opt_state, loss = step(params, opt_state, jax.random.key(it))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_forest_sharded_train_step():
    """Block-axis-sharded forest training on the 8-device CPU mesh:
    per-block LoTD params placed block→device, grads psum'd by pjit
    (VERDICT #3 'done': sharded forest train-step)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nr3d_lib_tpu.parallel import make_mesh

    m = _two_block_model()
    graphdef, params, rest = nn.split(m, nn.Param, ...)
    mesh = make_mesh([8], ("block",))

    def shard_leaf(path, leaf):
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        if "flattened_params" in name and leaf.ndim == 2 \
                and leaf.shape[0] % 8 == 0:
            return jax.device_put(leaf, NamedSharding(mesh, P("block", None)))
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    params_sh = jax.tree_util.tree_map_with_path(shard_leaf, params)

    o = jnp.asarray([[-2.0, 0.1, 0.1], [2.0, 0.3, -0.2]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    gt = jnp.asarray([[0.2, 0.4, 0.6], [0.6, 0.4, 0.2]])

    def loss_fn(p):
        mm = nn.merge(graphdef, p, rest)
        r, _ = mm.ray_query(mm.ray_test(o, d))
        return jnp.mean((r["rgb_volume"] - gt) ** 2)

    g_ref = jax.grad(loss_fn)(params)
    g_sh = jax.jit(jax.grad(loss_fn))(params_sh)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(g_ref),
            jax.tree_util.tree_leaves_with_path(g_sh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    # the per-block grad really is laid out over the block axis
    enc_g = [leaf for path, leaf in jax.tree_util.tree_leaves_with_path(g_sh)
             if "flattened_params" in "/".join(
                 str(getattr(p, "key", getattr(p, "idx", p))) for p in path)][0]
    assert len(enc_g.sharding.device_set) == 8


def test_forest_segment_raytrace():
    """ray_test_segments: entry-sorted disjoint block segments matching an
    analytic two-block setup (reference SPC raytrace forest.py:305-396)."""
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    sp = ForestBlockSpace(resolution=(4, 1, 1), origin=(0.0, 0.0, 0.0),
                          block_size=1.0)
    # occupy blocks x=0 and x=2 (gap at x=1)
    sp.populate_from_corners(np.asarray([[0, 0, 0], [2, 0, 0]]))
    o = jnp.asarray([[-1.0, 0.5, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    segs = sp.ray_test_segments(o, d, max_segments=4)
    n = int(segs["n_segs"][0])
    assert n == 2
    tin = np.asarray(segs["seg_t_in"][0, :n])
    tout = np.asarray(segs["seg_t_out"][0, :n])
    assert np.allclose(tin, [1.0, 3.0], atol=1e-5)
    assert np.allclose(tout, [2.0, 4.0], atol=1e-5)
    # entry-sorted and disjoint
    assert tin[0] < tin[1] and tout[0] <= tin[1]
    # a miss ray
    o2 = jnp.asarray([[-1.0, 5.0, 0.5]])
    segs2 = sp.ray_test_segments(o2, d, max_segments=4)
    assert int(segs2["n_segs"][0]) == 0 and not bool(segs2["mask"][0])

    # march_segments spends all slots inside occupied blocks
    t, dt, bidx, mask = sp.march_segments(segs, steps_per_segment=8)
    tm = np.asarray(t[0][np.asarray(mask[0])])
    assert len(tm) == 16
    inside = ((tm >= 1.0) & (tm < 2.0)) | ((tm >= 3.0) & (tm < 4.0))
    assert inside.all()
    assert (np.diff(np.asarray(t[0])) >= -1e-6).all()  # globally t-sorted
    bm = np.asarray(bidx[0][np.asarray(mask[0])])
    assert set(bm.tolist()) == {0, 1}


def test_forest_segment_march_mode_model():
    """march_mode='segments' model renders and concentrates samples in
    occupied blocks vs the fixed-step marcher."""
    m = _two_block_model(march_mode="segments", max_segments=8,
                         steps_per_segment=8)
    o = jnp.asarray([[-2.0, -0.5, -0.5]] * 4)
    d = jnp.asarray([[1.0, 0.0, 0.0]] * 4)
    rt = m.ray_test(o, d)
    rendered, vb = m.ray_query(rt, key=jax.random.key(0))
    assert np.isfinite(np.asarray(rendered["rgb_volume"])).all()
    assert np.isfinite(np.asarray(rendered["depth_volume"])).all()


def test_forest_populate_from_mesh_and_cameras():
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    # a triangle sitting in block (0,0,0) of a 2x2x2 forest
    sp = ForestBlockSpace(resolution=(2, 2, 2), origin=(0.0, 0.0, 0.0),
                          block_size=1.0)
    verts = np.asarray([[0.2, 0.2, 0.2], [0.8, 0.2, 0.2], [0.2, 0.8, 0.2]])
    faces = np.asarray([[0, 1, 2]])
    sp.populate_from_mesh(verts, faces)
    occ = np.asarray(sp.occupied[...])
    assert occ[0, 0, 0] and occ.sum() == 1

    # camera at origin looking +z covers blocks along z
    sp2 = ForestBlockSpace(resolution=(2, 2, 2), origin=(-1.0, -1.0, 0.0),
                          block_size=1.0)
    c2w = np.eye(4)
    K = np.asarray([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]])
    sp2.populate_from_pinhole_cameras([c2w], [K], (64, 64), near=0.1,
                                      far=1.9)
    assert sp2.n_trees >= 1
    assert np.asarray(sp2.occupied[...]).any()


def test_forest_hierarchical_segments_parity():
    """Two-level supercell culling (the SPC-octree stand-in — VERDICT #10,
    reference spatial/forest.py:305-396) must reproduce the dense
    ray_test_segments exactly when coarse_keep covers all supercell hits."""
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    rng = np.random.default_rng(0)
    # sparse road-like occupancy in a 32^3 block grid
    sp = ForestBlockSpace(resolution=(32, 32, 8), origin=(-8.0, -8.0, -2.0),
                          block_size=0.5)
    ix = np.arange(32)
    road = np.stack([ix, (8 + 0.4 * ix).astype(np.int64) % 32,
                     np.full(32, 2)], -1)
    blocks = np.concatenate([road + off for off in
                             [[0, 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1]]])
    blocks = np.unique(np.clip(blocks, 0, [31, 31, 7]), axis=0)
    sp.populate_from_corners(blocks)
    assert sp._super_coords.shape[0] > 4

    n = 64
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(2.0, 4.0, n)
    tgt = np.asarray(sp.block_coords)[rng.integers(0, sp.n_trees, n)]
    tgt = (np.asarray(sp.origin[...]) + (tgt + rng.random((n, 3)))
           * sp.block_size).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    dense = sp.ray_test_segments(jnp.asarray(o), jnp.asarray(d),
                                 max_segments=16, hierarchy=False)
    hier = sp.ray_test_segments(jnp.asarray(o), jnp.asarray(d),
                                max_segments=16, hierarchy=True,
                                coarse_keep=sp._super_coords.shape[0])
    assert np.asarray(dense["mask"]).any()
    for k in ["seg_bidx", "seg_mask", "n_segs", "mask"]:
        np.testing.assert_array_equal(np.asarray(dense[k]),
                                      np.asarray(hier[k]), err_msg=k)
    m = np.asarray(dense["seg_mask"])
    for k in ["seg_t_in", "seg_t_out"]:
        np.testing.assert_allclose(np.asarray(dense[k])[m],
                                   np.asarray(hier[k])[m],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ["near", "far"]:
        np.testing.assert_allclose(np.asarray(dense[k]), np.asarray(hier[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)

    # truncated coarse_keep stays a valid (near-sorted) subset
    hier4 = sp.ray_test_segments(jnp.asarray(o), jnp.asarray(d),
                                 max_segments=16, hierarchy=True,
                                 coarse_keep=4)
    ti = np.asarray(hier4["seg_t_in"])
    msk = np.asarray(hier4["seg_mask"])
    for r in range(n):
        tt = ti[r][msk[r]]
        assert (np.diff(tt) >= -1e-6).all()


def test_forest_deep_hierarchy_parity():
    """N-level descent (max_top forces 3 super levels on a small forest):
    segments must match the dense path when coarse_keep covers every hit,
    and the hierarchy must actually be deep."""
    from nr3d_lib_tpu.models.spatial.forest import ForestBlockSpace

    rng = np.random.default_rng(1)
    sp = ForestBlockSpace(resolution=(64, 64, 8), origin=(-8.0, -8.0, -1.0),
                          block_size=0.25)
    ix = np.arange(64)
    road = np.stack([ix, (16 + 0.6 * ix).astype(np.int64) % 64,
                     np.full(64, 3)], -1)
    blocks = np.unique(np.concatenate(
        [road + off for off in [[0, 0, 0], [0, 2, 0], [3, 0, 0]]]), axis=0)
    blocks = np.clip(blocks, 0, [63, 63, 7])
    sp.populate_from_corners(blocks)
    # rebuild with factor 2 and a tiny top cap → several super levels
    sp._build_hierarchy(factor=2, max_top=4)
    assert len(sp._hier_coords) >= 3, [c.shape for c in sp._hier_coords]

    n = 48
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(1.5, 3.0, n)
    tgt = np.asarray(sp.block_coords)[rng.integers(0, sp.n_trees, n)]
    tgt = (np.asarray(sp.origin[...]) + (tgt + rng.random((n, 3)))
           * sp.block_size).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    dense = sp.ray_test_segments(jnp.asarray(o), jnp.asarray(d),
                                 max_segments=16, hierarchy=False)
    hier = sp.ray_test_segments(jnp.asarray(o), jnp.asarray(d),
                                max_segments=16, hierarchy=True,
                                coarse_keep=64)
    assert np.asarray(dense["mask"]).any()
    for k in ["seg_bidx", "seg_mask", "n_segs", "mask"]:
        np.testing.assert_array_equal(np.asarray(dense[k]),
                                      np.asarray(hier[k]), err_msg=k)
    m = np.asarray(dense["seg_mask"])
    for k in ["seg_t_in", "seg_t_out"]:
        np.testing.assert_allclose(np.asarray(dense[k])[m],
                                   np.asarray(hier[k])[m], rtol=1e-5)
