"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``, importing them
loads no JAX, and entry points refuse to fall back to the CPU quietly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path}: imports {bad}"


def test_every_port_module_is_checked():
    """The walk above reaches every module, the weight-driven policies' own
    (Threefry, the baselines, Keyformer), the evaluation's (the tasks) and
    the serving extras' (the prefix cache, the workload traces, the serve
    launcher) and the hybrids' (RG-LRU, SSD and its chunk op) included."""
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"core/threefry.py", "core/baselines.py", "core/keyformer.py",
            "core/policy.py", "kernels/dms_decode/ops.py", "data/tasks.py",
            "core/hyperscale.py", "serving/prefix_cache.py",
            "serving/workload.py", "launch/serve.py", "models/rglru.py",
            "models/ssd.py", "kernels/ssd/ops.py"} <= names


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not leaked, leaked\n"
            "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import get_smoke
    from repro_torch.core.config import KVPolicyConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine
    arch = get_smoke("qwen-r1-1.5b")
    policy = KVPolicyConfig(kind="dms", cr=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_model(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_decode_state(arch, 1, 8, policy)
    params = tfm.init_model(arch, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(arch, params, policy)
    Engine(arch, params, policy, device="cpu")        # asked for: fine


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Alone in a directory, or on a machine without CUDA, the smoke script
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
