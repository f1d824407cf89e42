"""Process set-up: the compile-cache helper and chip_smoke.py's refusal to
run without a GPU."""

import json
import os
import subprocess
import sys

import jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory."""
    from nr3d_lib_tpu.utils import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dir(monkeypatch):
    """Without the variable the cache is the fixed <repo>/.jax_cache."""
    from nr3d_lib_tpu.utils import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == os.path.join(_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert enable_compile_cache() == path        # stable, not per-call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return True
    try:
        return json.loads(lines[-1]).get("ok") is not True
    except (ValueError, AttributeError):
        return True


def test_chip_smoke_refuses_cpu():
    for args in ([], ["--multi-gpu"]):
        r = _run_smoke(args, _ROOT)
        assert r.returncode != 0, r.stdout
        assert _no_result(r.stdout)
        assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied alone into an empty directory it cannot import the package
    and exits non-zero without a result line."""
    src = os.path.join(_ROOT, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    r = _run_smoke([], str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0 and _no_result(r.stdout)
