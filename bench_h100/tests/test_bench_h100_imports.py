"""What the benchmark loads: the harness never JAX, Flax or the JAX
package (top-level module names compared whole), and the reference
nothing of the program either."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_pathtracer"}


def loaded_after(code: str) -> set:
    probe = code + "; import json, sys; print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = loaded_after(
        "from bench_h100 import run; c, res = run.run(['--workload', 'spheres1080.batch', '--seed', '7', "
        "'--seconds', '0.1', '--trace', '0'], device='cpu', overrides={'render': {'width': 16, 'height': 12}, "
        "'mix': {'check_pixels': 8}}); assert c == 0 and res['correct']")
    assert "tpu_pathtracer_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_after("import bench_h100.reference.render, bench_h100.check, bench_h100.traffic, "
                        "bench_h100.scenes.three_spheres, bench_h100.kinds.accumulate, bench_h100.kinds.orbit, "
                        "bench_h100.scenes.procedural_hdr")
    assert not mods & (FORBIDDEN | {"tpu_pathtracer_torch"}), mods & (FORBIDDEN | {"tpu_pathtracer_torch"})


def test_the_run_refuses_jax_when_loaded(monkeypatch):
    from bench_h100 import run

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "tpu_pathtracer_torch_x", object())
    assert run.forbidden_modules() == []
