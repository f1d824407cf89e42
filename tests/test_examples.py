"""Smoke-run every example script end to end (tiny sizes).

The examples are the library's downstream-workflow surface (the reference
ships no trainer); each must run its FULL pipeline — train, eval, export —
not just import. Subprocess-run so argument parsing and script wiring are
covered too (a broken eval/export tail is exactly what unit tests of the
underlying modules miss).
"""

import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples", script),
         "--cpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=_ROOT, env=env)
    assert r.returncode == 0, f"{script} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


@pytest.mark.parametrize("script,args,expect", [
    ("train_nerf_synthetic.py",
     ("--iters", "3", "--rays", "128"), "val PSNR"),
    ("train_neus_object.py",
     ("--iters", "3", "--rays", "128", "--mesh_res", "32"), "chamfer"),
    ("train_dynamic_scene.py",
     ("--iters", "3", "--rays", "128", "--hw", "24"), "decomposition"),
    ("train_generative_shapes.py",
     ("--iters", "3", "--rays", "128", "--hw", "24"), "interpolation"),
    ("train_forest_street.py",
     ("--iters", "3", "--rays", "128"), "trained"),
    ("train_conditional_dynamic.py",
     ("--iters", "3", "--rays", "128", "--hw", "24"), "grid"),
])
def test_example_smoke(tmp_path, script, args, expect):
    out = _run(script, *args, "--out", str(tmp_path / "run"))
    assert expect in out, f"{script} missing '{expect}' in output:\n{out}"
