"""The ``reads_tokens`` meter is the policy's, not its live count.

Every registered policy's ``decode_step`` reports the reference's
``live_tokens`` and ``reads_tokens`` at every step of a short trace with a
frozen lane (both exact).  The seven policies ported before Quest and DMC
read what they hold, as they did when ``decode_attention`` reported its
live count on both axes: reads equal live on active lanes and are zero on
frozen ones.  Quest reads fewer once its cache outgrows ``top_pages``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core.config import KVPolicyConfig as JKV
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.core.config import KVPolicyConfig
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port(tiny_arch, tiny_params):
    tarch = bridge.arch_from_dict(dataclasses.asdict(tiny_arch))
    return tarch, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tiny_params), tarch, device="cpu")


@pytest.mark.parametrize("kind", sorted(jpolicy.available_policies()))
def test_decode_step_meters_equal_reference(tiny_arch, tiny_params, port,
                                            kind):
    tarch, tparams = port
    kw = dict(kind=kind, cr=2.0, budget=6, block_p=4, quest_page_size=4,
              quest_top_pages=1)
    b, max_len = 2, 16
    jstate = jtfm.init_decode_state(tiny_arch, b, max_len, JKV(**kw))
    tstate = ttfm.init_decode_state(tarch, b, max_len, KVPolicyConfig(**kw),
                                    device="cpu")
    toks = np.random.default_rng(6).integers(3, tiny_arch.vocab_size,
                                             size=(8, b))
    pos = np.zeros(b, np.int32)
    below = False
    for t in range(8):
        act = np.array([True, t % 4 != 3])
        tok = toks[t][:, None].astype(np.int32)
        _, jstate, jaux = jtfm.decode_step(
            tiny_params, jnp.asarray(tok), jstate, tiny_arch,
            jnp.asarray(pos), use_kernel=False, active=jnp.asarray(act))
        _, tstate, taux = ttfm.decode_step(
            tparams, torch.from_numpy(tok), tstate, tarch,
            torch.from_numpy(pos), use_kernel=False,
            active=torch.from_numpy(act))
        for key in ("live_tokens", "reads_tokens"):
            np.testing.assert_array_equal(taux[key].numpy(),
                                          np.asarray(jaux[key]),
                                          err_msg=f"{kind} {key} step {t}")
        live, reads = taux["live_tokens"].numpy(), taux["reads_tokens"].numpy()
        if kind == "quest":
            below |= bool((reads[act] < live[act]).any())
        else:
            np.testing.assert_array_equal(reads, np.where(act, live, 0.0))
        pos = pos + act
    assert below == (kind == "quest")
