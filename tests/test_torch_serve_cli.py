"""``python -m repro_torch.launch.serve`` against ``python -m
repro.launch.serve``: on the same argv (plus ``--device cpu``) and the same
weights (the reference's seeded init, copied through numpy, stand in for
the port's own), the port prints the same lines — the per-request JSON
(statuses, meters, ticks, TTFT/TPOT), the summary table, and the run's,
SLO's, pool's and prefix cache's counters (the last with the port's own
``import_degrades``).  Without ``--device cpu`` it asks for the card, and
raises where there is none."""
import dataclasses
import json

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.launch import serve as tserve

# tiny shapes run fastest on one thread, and test workers share the cores
torch.set_num_threads(1)

BASE = ["--requests", "4", "--num-lanes", "2", "--prompt-len", "16",
        "--max-new", "6"]
ARGVS = {
    "prefix-stagger-width2": BASE + ["--prefix-cache-mb", "64",
                                     "--shared-prefix", "16", "--stagger",
                                     "--width", "2"],
    "prefix-hot-paged": BASE + ["--prefix-cache-mb", "64",
                                "--prefix-cache-device-mb", "8",
                                "--shared-prefix", "16", "--stagger",
                                "--paged", "--use-kernel"],
    "burst-slo": BASE + ["--arrival", "burst", "--rate", "2.0",
                         "--slo-ttft", "6", "--max-queue", "2", "--width",
                         "2", "--deadline", "12", "--requests", "8"],
    "gemma2-prefix-paged": BASE + ["--arch", "gemma2-2b", "--prefix-cache-mb",
                                   "64", "--shared-prefix", "16",
                                   "--stagger", "--paged", "--use-kernel"],
}


def _params(arch_name="qwen-r1-1.5b"):
    jarch = jget_smoke(arch_name)
    jparams = jtfm.init_model(jax.random.PRNGKey(0), jarch)
    tarch = bridge.arch_from_dict(dataclasses.asdict(jarch))
    return bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), tarch, device="cpu")


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_serve_prints_what_the_reference_prints(name, capsys, monkeypatch):
    argv = ARGVS[name]
    jserve.main(argv)
    want = capsys.readouterr().out.splitlines()
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else \
        "qwen-r1-1.5b"
    params = _params(arch)
    monkeypatch.setattr(tserve.tfm, "init_model", lambda *a, **k: params)
    tserve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        if w.startswith('{"prefix_cache"'):
            # the port also counts the paged imports it degraded to a cold
            # prefill; sound admission (no --oversub) never degrades one
            w = json.loads(w)
            w["prefix_cache"]["import_degrades"] = 0
            assert json.loads(g) == w
        else:
            assert g == w


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(BASE + ["--device", "cuda"])
