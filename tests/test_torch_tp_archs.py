"""Tensor parallelism over the other dense decoders: Gemma3, Nemotron and
Llama3 on data 2 × model 2 against the reference's ``build_train_step``
on ``make_host_mesh(data=2, model=2)``.

Four gloo ranks beside one JAX subprocess per model, from the same
numpy weights and batches (each model's smoke config, f32, 32 tokens a
sequence): 2 steps of ``dense`` and of ``lags_dp`` with the kernel
backend (its plain version on the CPU).  They cover what
``test_torch_tp.py``'s TinyLlama does not: Gemma3's tied,
vocab-sharded ``embed`` through ``L.unembed`` and its windowed layers
(window 16, local/global period 2), and Nemotron's layer norm and
ungated squared-ReLU FFN.

Contracts: losses rtol 1e-5, the same on every rank; the gathered
parameters rtol 1e-4 atol 1e-5, the same on every rank; under
``lags_dp`` each rank's residual chunk against its chunk of the
reference's per-worker residual, rtol 1e-4 atol 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA, MODEL, STEPS, B, S = 2, 2, 2, 8, 32
WORLD = DATA * MODEL
ARCHS = ("gemma3_27b", "nemotron_4_340b", "llama3_8b")
# name -> (mode, port backend)
MODES = {"dense": ("dense", "xla"), "lags_dp": ("lags_dp", "kernel")}
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16)

JAX_SCRIPT = """
import sys
import jax, numpy as np
from repro import api, compat
from repro.configs import base
from repro.launch import mesh as M, train as TR

arch, inp, out_path = sys.argv[1], np.load(sys.argv[2]), sys.argv[3]
cfg = base.get_smoke_config(arch)
mesh = M.make_host_mesh(data=DATA, model=MODEL)
is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
out = {}
for name, (mode, _) in MODES.items():
    run = api.RunConfig(mode=mode, donate=False, **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    state, _ = TR.init_state(cfg, mesh, method=mode)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"{arch}/param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            batch = {"tokens": inp[f"{arch}/tokens"][t],
                     "labels": inp[f"{arch}/labels"][t]}
            state, metrics = step(state, batch)
            out[f"{arch}/{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef"):
        for i, x in enumerate(jax.tree.leaves(state.get(part, ()))):
            out[f"{arch}/{name}/{part}{i}"] = np.asarray(x)
    specs = jax.tree.leaves(meta["pspecs"], is_leaf=is_spec)
    out[f"{arch}/sdims"] = np.array([
        next((i for i, e in enumerate(s) if e == "model"), -1)
        for s in specs])
np.savez(out_path, **out)
print("OK jax", arch)
"""

RANK_SCRIPT = """
import sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import api, tree
from repro_torch.configs import base
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT
from repro_torch.sharding import dtensor as D

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", WORLD, rank, device="cpu")
mesh = M.make_mesh(model=MODEL, device="cpu")
out = {}
for arch in ARCHS:
    cfg = base.get_smoke_config(arch)
    leaves, treedef = tree.flatten(TT.abstract_params(cfg))
    start = tree.unflatten(treedef, [inp[f"{arch}/param{i}"]
                                     for i in range(len(leaves))])
    for name, (mode, backend) in MODES.items():
        sess = api.Session(cfg, api.RunConfig(
            mode=mode, selection_backend=backend, **RUN_KW), mesh=mesh)
        state, _ = sess.init_state(
            params=TT.from_jax_params(start, cfg, device="cpu").params)
        for t in range(STEPS):
            batch = {"tokens": torch.from_numpy(inp[f"{arch}/tokens"][t]),
                     "labels": torch.from_numpy(inp[f"{arch}/labels"][t])}
            state, metrics = sess.step_fn(state, batch)
            out[f"{arch}/{name}/loss{t}"] = float(metrics["loss"])
        for i, x in enumerate(tree.leaves(D.gather(state["params"]))):
            out[f"{arch}/{name}/params{i}"] = x.numpy()
        for i, x in enumerate(tree.leaves(state["ef"])):
            out[f"{arch}/{name}/ef{i}"] = x.clone().numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants() -> str:
    return "".join(f"{n} = {globals()[n]!r}\n" for n in (
        "DATA", "MODEL", "WORLD", "STEPS", "ARCHS", "MODES", "RUN_KW"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX subprocess a model and four gloo ranks, started together;
    returns (JAX results, per-rank port results)."""
    from repro.configs import base
    from repro.models import transformer as JT
    tmp = tmp_path_factory.mktemp("tp_archs")
    rng = np.random.default_rng(7)
    inp = {}
    for arch in ARCHS:
        cfg = base.get_smoke_config(arch)
        params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        for i, p in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param{i}"] = np.asarray(p)
        toks = rng.integers(0, cfg.vocab, (STEPS, B, S + 1)).astype(
            np.int32)
        inp[f"{arch}/tokens"], inp[f"{arch}/labels"] = (toks[..., :-1],
                                                        toks[..., 1:])
    np.savez(tmp / "in.npz", **inp)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    code = _constants() + textwrap.dedent(JAX_SCRIPT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, arch, str(tmp / "in.npz"),
         str(tmp / f"jax_{arch}.npz")], env=env, stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in ARCHS]
    code = _constants() + textwrap.dedent(RANK_SCRIPT)
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(tmp / "store"),
             str(tmp / "in.npz"), str(tmp / f"rank{r}.npz")],
            env=dict(env, OMP_NUM_THREADS="1"), stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    jres = {}
    for arch in ARCHS:
        jres.update(np.load(tmp / f"jax_{arch}.npz"))
    return jres, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_match_jax_build_train_step(runs, arch, name):
    """2 steps on data 2 × model 2 against the reference: losses rtol
    1e-5; gathered parameters rtol 1e-4 atol 1e-5; every rank the same;
    under ``lags_dp`` each rank's residual chunk against its chunk of the
    reference's worker state."""
    jres, ranks = runs
    key = f"{arch}/{name}"
    got = ranks[0]
    np.testing.assert_allclose(
        [got[f"{key}/loss{t}"] for t in range(STEPS)],
        [jres[f"{key}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    n = len([k for k in jres if k.startswith(f"{key}/params")])
    assert n >= 9, n
    sdims = jres[f"{arch}/sdims"]
    assert (sdims >= 0).sum() > 0
    for i in range(n):
        np.testing.assert_allclose(got[f"{key}/params{i}"],
                                   jres[f"{key}/params{i}"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{key} leaf {i}")
    for r, res in enumerate(ranks):
        for t in range(STEPS):
            assert res[f"{key}/loss{t}"] == got[f"{key}/loss{t}"]
        for i in range(n):
            np.testing.assert_array_equal(res[f"{key}/params{i}"],
                                          got[f"{key}/params{i}"])
        efs = [k for k in jres if k.startswith(f"{key}/ef")]
        assert len(efs) == (n if name == "lags_dp" else 0)
        d, m = divmod(r, MODEL)
        for k in efs:
            i = int(k[len(f"{key}/ef"):])
            want = jres[k][d]
            if sdims[i] >= 0:
                want = np.split(want, MODEL, axis=sdims[i])[m]
            np.testing.assert_allclose(res[k][0], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{k} rank {r}")
