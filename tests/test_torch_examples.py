"""The port's examples, ``python -m repro_torch.examples.quickstart``,
``retrofit_train`` and ``hyperscale_serve``, run short on the CPU
(``--device cpu --steps 4``, and 2 eval problems for ``hyperscale_serve``)
in a fresh interpreter: each finishes, prints its final line, and leaves no
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
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {"jax", "jaxlib", "repro"})))
"""
SHORT = ["--device", "cpu", "--steps", "4"]
# name -> (its short argv, a piece of its final line)
CASES = {"hyperscale_serve": (SHORT + ["--n-eval", "2"],
                              "hyper-scaling: the compressed model affords"),
         "quickstart": (SHORT, "hyper-scaling spends that budget"),
         "retrofit_train": (SHORT, "final: alpha=")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu_without_jax(name):
    argv, final = CASES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUN, f"repro_torch.examples.{name}", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == [], lines[-1]
    assert final in lines[-2], lines[-3:]
    assert "on cpu" in proc.stdout
