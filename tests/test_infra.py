"""L0 infra tests: config, checkpoint, profiler, logger, utils, parallel."""

import os

import numpy as np
import pytest


def test_configdict_basic():
    from nr3d_lib_tpu.config import ConfigDict

    c = ConfigDict({"a": 1, "b": {"c": [1, {"d": 2}]}})
    assert c.a == 1
    assert c.b.c[1].d == 2
    c.b.e = {"f": 3}
    assert c["b"]["e"].f == 3
    c2 = c.copy()
    c2.b.c = 0
    assert c.b.c[0] == 1  # deep copy


def test_merge_dotlist_and_dicts():
    from nr3d_lib_tpu.config import ConfigDict, merge_dicts, merge_dotlist

    base = ConfigDict({"model": {"lr": 0.1, "dims": [1, 2]}, "n": 5})
    out = merge_dotlist(base, ["model.lr=0.5", "model.new.x=true", "n=7"])
    assert out.model.lr == 0.5 and out.model.new.x is True and out.n == 7
    assert base.model.lr == 0.1  # original untouched

    m = merge_dicts({"a": {"b": 1, "c": 2}}, {"a": {"b": 9}})
    assert m.a.b == 9 and m.a.c == 2


def test_yaml_load_with_base_and_resolvers(tmp_path):
    from nr3d_lib_tpu.config import load_config

    (tmp_path / "base.yaml").write_text("model:\n  width: 64\n  depth: 2\n")
    (tmp_path / "child.yaml").write_text(
        "_base_: base.yaml\nmodel:\n  depth: 4\n  scale: ${eval:2**3}\n")
    cfg = load_config(tmp_path / "child.yaml")
    assert cfg.model.width == 64 and cfg.model.depth == 4 and cfg.model.scale == 8


def test_baseconfig_parse(tmp_path):
    from nr3d_lib_tpu.config import BaseConfig

    (tmp_path / "cfg.yaml").write_text("training:\n  lr: 0.01\nname: exp\n")
    cfg = BaseConfig().parse([
        "--config", str(tmp_path / "cfg.yaml"), "training.lr=0.5", "--device_ids", "0,1"])
    assert cfg.training.lr == 0.5
    assert cfg.name == "exp"
    assert cfg.device_ids == [0, 1]


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from nr3d_lib_tpu.checkpoint import CheckpointIO, sorted_ckpts

    state = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
    io = CheckpointIO(str(tmp_path))
    io.register_modules(net=state)
    io.save("ckpt_100.npz", it=100)
    io.save("ckpt_latest.npz", it=200)

    io2 = CheckpointIO(str(tmp_path))
    io2.register_modules(net={"w": jnp.zeros((2, 3)), "b": jnp.ones(3)})
    extras = io2.load("ckpt_100.npz")
    assert extras["it"] == 100
    np.testing.assert_allclose(np.asarray(io2.module_dict["net"]["w"]),
                               np.arange(6.0).reshape(2, 3))
    ordered = sorted_ckpts(str(tmp_path))
    assert ordered[-1].endswith("latest.npz")


def test_profiler_tree():
    from nr3d_lib_tpu.profile import enable_profiling, profile

    prof = enable_profiling()
    with profile("outer"):
        with profile("inner"):
            _ = sum(range(1000))
        with profile("inner"):
            pass
    rep = prof.report()
    assert "outer" in rep and "inner" in rep
    outer = prof.root.children["outer"]
    assert outer.count == 1 and outer.children["inner"].count == 2


def test_logger(tmp_path):
    from nr3d_lib_tpu.logger import Logger

    lg = Logger(str(tmp_path), use_tensorboard=False)
    lg.add("train", "loss", 0.5, 1)
    lg.add_nested_dict("train", {"a": {"b": 1.0}}, 2)
    lg.add_imgs("val", "rgb", np.random.rand(8, 8, 3), 1)
    lg.save_stats()
    lg.close()
    assert os.path.exists(tmp_path / "scalars.jsonl")
    assert os.path.exists(tmp_path / "stats.p")
    lg2 = Logger(str(tmp_path), use_tensorboard=False)
    lg2.load_stats()
    assert ("train/loss", ) != () and len(lg2.stats["train/loss"]) == 1


def test_utils_nested_and_dtype():
    import jax.numpy as jnp

    from nr3d_lib_tpu.utils import (check_to_jax, collate_nested_dict, jax_dtype,
                                    nested_dict_get, nested_dict_keys, nested_dict_set)

    d = {"a": {"b": 1}, "c": 2}
    assert nested_dict_keys(d) == [("a", "b"), ("c",)]
    assert nested_dict_get(d, ("a", "b")) == 1
    nested_dict_set(d, ("a", "x"), 5)
    assert d["a"]["x"] == 5

    assert jax_dtype("half") == jnp.bfloat16
    arr = check_to_jax([1.0, 2.0], dtype=jnp.float32)
    assert arr.dtype == jnp.float32

    col = collate_nested_dict([{"x": jnp.ones(3)}, {"x": jnp.zeros(3)}])
    assert col["x"].shape == (2, 3)


def test_mesh_creation_8_devices():
    import jax

    from nr3d_lib_tpu.parallel import make_mesh

    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    mesh = make_mesh()
    assert mesh.shape["data"] == 8 and mesh.shape["block"] == 1
    mesh2 = make_mesh([4, 2])
    assert mesh2.shape["data"] == 4 and mesh2.shape["block"] == 2


def test_marching_cubes_sphere(tmp_path):
    from nr3d_lib_tpu.graphics.trianglemesh import extract_mesh

    def sdf(x):
        return np.linalg.norm(x, axis=-1) - 0.5

    verts, faces = extract_mesh(sdf, resolution=32)
    assert len(verts) > 0 and len(faces) > 0
    r = np.linalg.norm(verts, axis=-1)
    assert abs(np.median(r) - 0.5) < 0.1


def test_instantiate_and_config_zoo():
    """Every example config builds its model via config.instantiate
    (the downstream target/param construction pattern)."""
    import glob
    import os

    from nr3d_lib_tpu.config import instantiate, load_config

    cfg_dir = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "configs")
    paths = sorted(glob.glob(os.path.join(cfg_dir, "*.yaml")))
    built = 0
    for p in paths:
        if os.path.basename(p).startswith("_"):
            continue
        cfg = load_config(p)
        assert cfg.training.lr == 5.0e-3          # _base_ include merged
        model = instantiate(cfg.model, seed=int(cfg.seed))
        assert model is not None
        built += 1
    assert built >= 6


def test_instantiate_overrides():
    from nr3d_lib_tpu.config import instantiate

    obj = instantiate({"target": "collections.OrderedDict",
                       "param": {"a": 1}}, b=2)
    assert obj == {"a": 1, "b": 2}
