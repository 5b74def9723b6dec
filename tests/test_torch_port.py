"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to ``cuda`` (and raise without a
card), what the slice has not ported raises naming its ROADMAP item, and
its tree flattening follows ``jax.tree.leaves``."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, tree  # noqa: E402
from repro_torch.configs import tinyllama_1_1b  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port pulls in no jax and no repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_no_source_file_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s))", re.M)
    files = list(PKG.rglob("*.py")) + [PKG.parents[1] / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        assert not pattern.search(f.read_text()), f


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so cuda is a valid default here")


def test_entry_points_default_to_cuda_and_raise_without_card():
    _no_card()
    cfg = tinyllama_1_1b.smoke_config()
    with pytest.raises(RuntimeError, match="cuda"):
        api.Session(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.Transformer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic.MarkovLM(vocab=16).worker_batches(0, 2, 1, 8)


def test_trainer_refuses_params_on_another_device():
    _no_card()
    module = TT.Transformer(tinyllama_1_1b.smoke_config(), device="cpu")
    from repro_torch.training import train_loop
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.SimTrainer(lambda p, b: None, module.params,
                              api.RunConfig(mode="dense"), 2)


# each of these knobs but health_every is ported now: beside
# health_every > 0 the run still raises, naming item 12 and nothing else
@pytest.mark.parametrize("knob", [
    {"measure_delta": True}, {"health_every": 5},
    {"mode": "lags_hier", "compressor": "randk"},
    {"mode": "lags_hier2", "inner_compressor": "randk"},
    {"schedule": object()},
    {"compressor": "randk"}])
def test_unported_knobs_raise_naming_roadmap(knob):
    cfg = tinyllama_1_1b.smoke_config()
    module = TT.Transformer(cfg, device="cpu")
    run = api.RunConfig(**({"mode": "lags_dp", "health_every": 5} | knob))
    assert run.unported() == ["health_every > 0 (ROADMAP.md queue 1 "
                              "item 12)"]
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        api.Session(cfg, run, device="cpu").simulator(
            lambda p, b: TT.loss_fn(p, cfg, b), module.params, 2)


@pytest.mark.parametrize("knob", [
    {"measure_delta": True}, {"health_every": 5}, {"schedule": object()}])
def test_distributed_step_raises_for_unported_knobs(knob):
    """The distributed step refuses what it has not ported
    (health_every > 0) before it touches the mesh; the other knobs are
    ported and do not add to the refusal."""
    run = api.RunConfig(mode="lags_dp", **({"health_every": 5} | knob))
    with pytest.raises(NotImplementedError, match=(
            r"not ported yet: \['health_every > 0 \(ROADMAP\.md queue 1 "
            r"item 12\)'\]$")):
        api.build_train_step(tinyllama_1_1b.smoke_config(), None, run)


def test_run_config_rejects_wave_with_momentum_correction():
    with pytest.raises(ValueError, match="momentum_correction"):
        api.RunConfig(pipeline="wave", momentum_correction=0.9)


def test_run_config_mirrors_reference_fields():
    jax_cfg = pytest.importorskip("repro.api.config")
    names = [f.name for f in dataclasses.fields(api.RunConfig)]
    assert names == [f.name for f in dataclasses.fields(jax_cfg.RunConfig)]
    assert api.canonical_mode("lags") == "lags_dp"
    with pytest.raises(ValueError):
        api.RunConfig(selection_backend="triton")


def test_flatten_order_matches_jax():
    jax = pytest.importorskip("jax")
    nested = {"z": [np.ones(1), {"b": np.ones(2), "a": np.ones(3)}],
              "a": {"y": np.ones(4), "x": [np.ones(5), np.ones(6)]},
              "m": [], "k": np.ones(7)}
    assert [x.size for x in tree.leaves(nested)] == \
        [x.size for x in jax.tree.leaves(nested)]
    flat, treedef = tree.flatten(nested)
    again = tree.unflatten(treedef, flat)
    assert [x.size for x in tree.leaves(again)] == [x.size for x in flat]
    assert tree.leaf_paths(nested) == ["a/x/0", "a/x/1", "a/y", "k", "z/0",
                                       "z/1/a", "z/1/b"]


def test_tree_walkers_leave_no_reference_cycle():
    """Flattening must not keep leaves alive past their last reference (a
    recursive closure once held the 8 GiB update stack until the cyclic
    collector ran)."""
    import gc
    import weakref
    gc.disable()
    try:
        t = torch.zeros(3)
        alive = weakref.ref(t)
        nested = {"a": [t, {"b": t}]}
        flat, treedef = tree.flatten(nested)
        tree.unflatten(treedef, flat)
        tree.leaf_paths(nested)
        tree.map(lambda x: x + 0, nested)
        del t, nested, flat, treedef
        assert alive() is None
    finally:
        gc.enable()


def test_session_reconciles_mode_and_ratio():
    cfg = tinyllama_1_1b.smoke_config()
    module = TT.Transformer(cfg, device="cpu")
    sess = api.Session(cfg, api.RunConfig(mode="lags"), device="cpu")
    assert sess.mode == "lags_dp" and sess.cfg.train_mode == "lags_dp"
    tr = sess.simulator(lambda p, b: TT.loss_fn(p, cfg, b), module.params, 2)
    ks = tree.leaves(tr.exchange.ks)
    sizes = [p.numel() for p in tree.leaves(module.params)]
    assert ks == [max(1, round(d / cfg.compression_ratio)) for d in sizes]


def test_markov_batches_are_deterministic_and_in_range():
    data = synthetic.MarkovLM(vocab=16, seed=1)
    a = data.worker_batches(3, 2, 2, 8, device="cpu")
    b = data.worker_batches(3, 2, 2, 8, device="cpu")
    assert a["tokens"].shape == (2, 2, 8)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][..., 1:], a["labels"][..., :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 16
