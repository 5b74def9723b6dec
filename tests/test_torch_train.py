"""Three ``SimTrainer`` steps of the port against the JAX ``SimTrainer``:
the same parameters (as numpy), the same numpy batches, P=2 workers,
ratio 8, for ``dense`` and for ``lags_dp`` and ``slgs`` under both
selection backends, and with the DGC momentum correction.

Tolerance: losses rtol 1e-5, parameters atol 1e-5 + rtol 1e-4.  The
reference's jit may contract ``lr·g + e`` into one fma inside the step
(``repro/core/lags.py`` local_select_ef, parity note), and the model's
sums run in another order, so the two agree to float32 rounding rather
than bit for bit; the selections themselves are bitwise
(``test_torch_exchange.py``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.configs import tinyllama_1_1b as jcfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import tinyllama_1_1b as tcfg  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

P, STEPS, B, S = 2, 3, 2, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16)


def _batches(vocab):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (P, B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


@pytest.mark.parametrize("mode,backend", [("dense", "xla"),
                                          ("lags_dp", "xla"),
                                          ("lags_dp", "kernel"),
                                          ("slgs", "xla"),
                                          ("slgs", "kernel")])
def test_three_steps_match_jax(mode, backend):
    _three_steps(mode, backend, 0.0)


@pytest.mark.parametrize("mode,backend", [("lags_dp", "xla"),
                                          ("lags_dp", "kernel")])
def test_three_steps_with_momentum_correction_match_jax(mode, backend):
    """mc = 0.9: the per-worker DGC velocity (``mom = mc·mom + lr·g``)
    follows the reference's too."""
    ttr, jtr = _three_steps(mode, backend, 0.9)
    for got, want in zip(tree.leaves(ttr.state["mom"]),
                         jax.tree.leaves(jtr.state["mom"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def _three_steps(mode, backend, mc):
    cfg_j = dataclasses.replace(jcfg.smoke_config(), **SMALL)
    cfg_t = dataclasses.replace(tcfg.smoke_config(), **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg_j)
    module = TT.from_jax_params(jax.tree.map(np.asarray, params), cfg_t,
                                device="cpu")
    kw = dict(mode=mode, ratio=8.0, lr=0.1, selection_backend=backend,
              block_size=512, momentum_correction=mc)
    batches = _batches(cfg_j.vocab)

    jtr = japi.Session(cfg_j, japi.RunConfig(**kw)).simulator(
        lambda p, b: JT.loss_fn(p, cfg_j, b, chunk=8, loss_chunk=8),
        params, n_workers=P)
    ttr = tapi.Session(cfg_t, tapi.RunConfig(**kw), device="cpu").simulator(
        lambda p, b: TT.loss_fn(p, cfg_t, b, chunk=8, loss_chunk=8),
        module.params, n_workers=P)
    jhist = jtr.run(lambda t: jax.tree.map(jax.numpy.asarray, batches[t]),
                    STEPS, log_every=1)
    thist = ttr.run(lambda t: {k: torch.from_numpy(v)
                               for k, v in batches[t].items()},
                    STEPS, log_every=1)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for got, want in zip(tree.leaves(TT.to_numpy_tree(module)),
                         jax.tree.leaves(jtr.state["params"])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    if mode != "dense":     # the EF residuals follow too
        for got, want in zip(tree.leaves(ttr.state["ef"]),
                             jax.tree.leaves(jtr.state["ef"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
    return ttr, jtr
