"""The port's examples, ``python -m repro_torch.examples.quickstart`` and
``retrofit_train``, run short on the CPU (``--device cpu --steps 4``) in a
fresh interpreter: each finishes, prints its final line, and leaves no
module of JAX or of the reference package imported."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RUN = """
import json, runpy, sys
sys.argv = [sys.argv[1], "--device", "cpu", "--steps", "4"]
runpy.run_module(sys.argv[0], run_name="__main__")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {"jax", "jaxlib", "repro"})))
"""
FINAL = {"quickstart": "hyper-scaling spends that budget",
         "retrofit_train": "final: alpha="}


@pytest.mark.parametrize("name", sorted(FINAL))
def test_example_runs_on_the_cpu_without_jax(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUN, f"repro_torch.examples.{name}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == [], lines[-1]
    assert FINAL[name] in lines[-2], lines[-3:]
    assert "on cpu" in proc.stdout
