"""The port's distributed data-parallel surface against its simulation
surface and against the JAX reference: the counterpart of
``tests/test_distributed.py``.

Four gloo ranks run in CPU processes (``repro_torch.launch.mesh`` over a
file store), beside one JAX subprocess on a 4-device host mesh
(``make_host_mesh(data=4, model=1)``); both start from the same weights
(the reference's ``init_model(PRNGKey(0))``, put into the reference's
state and carried into the port with ``from_jax_params``) and the same
numpy batches, fp32, the shrunken config of ``test_distributed.py``.

Contracts:
  * the distributed ``BlockLAGSExchange`` (values and indices
    all-gathered over the ranks) equals the port's simulation path on
    the same updates bit for bit, mean and EF residual, two steps with
    the residual fed back; the ``kernel`` backend equals ``xla`` bit for
    bit (the counterpart of ``test_lags_dp_kernel_backend_bitwise_under_
    shard_map``); the dense all-reduce mean equals the simulation mean to
    f32 rounding (gloo sums in its own order);
  * 3 steps of ``dense``, ``lags_dp`` and ``lags_dp`` + momentum
    correction 0.9 through ``Session(cfg, run, mesh=...).train_step()``
    match the reference's ``build_train_step`` at ``test_torch_train.py``'s
    tolerances: losses rtol 1e-5, parameters, residuals and velocities
    rtol 1e-4 atol 1e-5 (XLA may contract ``lr·g + e`` into one fma and
    the model's sums run in another order).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro_torch.core import lags as TL  # noqa: E402

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS, B, S = 4, 3, 8, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, compression_ratio=8.0, dtype="float32",
             param_dtype="float32")
MODES = {"dense": ("dense", 0.0), "lags_dp": ("lags_dp", 0.0),
         "lags_dp_mc": ("lags_dp", 0.9)}
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16)
# exchange leaves: a short tail block, a one-element tail, many blocks
EX_LEAVES = {"a": (100,), "b": (257,), "c": (50, 100)}
EX_KS = {"a": 3, "b": 9, "c": 40}
EX_BLOCK = 64

JAX_SCRIPT = """
import dataclasses, sys
import jax, numpy as np
from repro import api, compat
from repro.configs import base
from repro.launch import mesh as M, train as TR

inp = np.load(sys.argv[1])
cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                          **SMALL)
mesh = M.make_host_mesh(data=4, model=1)
out = {}
for name, (mode, mc) in MODES.items():
    run = api.RunConfig(mode=mode, momentum_correction=mc, donate=False,
                        **RUN_KW)
    step, _, _ = api.build_train_step(cfg, mesh, run)
    state, _ = TR.init_state(cfg, mesh, method=mode, momentum_correction=mc)
    # the shared start (init_state's sharded draw is not init_model's)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            batch = {"tokens": inp["tokens"][t], "labels": inp["labels"][t]}
            state, metrics = step(state, batch)
            out[f"{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef"):
        for i, x in enumerate(jax.tree.leaves(state[part])):
            out[f"{name}/{part}{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("OK jax")
"""

RANK_SCRIPT = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import api, tree
from repro_torch.configs import tinyllama_1_1b
from repro_torch.core import lags as TL
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", WORLD, rank, device="cpu")
mesh = M.make_mesh(device="cpu")
assert M.n_workers(mesh, M.lags_axis_names(mesh, "lags_dp")) == WORLD
axes = M.worker_axes(mesh, M.data_axis_names(mesh))
out = {}

# the distributed exchanges on this rank's row of the stacked updates
for use_kernel in (False, True):
    ex = TL.BlockLAGSExchange(ks=EX_KS, block_size=EX_BLOCK,
                              use_kernel=use_kernel)
    e = {k: torch.from_numpy(inp[f"e0/{k}"][rank]) for k in EX_LEAVES}
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"][rank]) for k in EX_LEAVES}
        m, e = ex.exchange(u, e, axes)
        for k in EX_LEAVES:
            out[f"block{int(use_kernel)}/{t}/mean/{k}"] = m[k].numpy()
            out[f"block{int(use_kernel)}/{t}/ef/{k}"] = e[k].numpy()
dm, _ = TL.DenseExchange().exchange(
    {k: torch.from_numpy(inp[f"u0/{k}"][rank]) for k in EX_LEAVES}, (), axes)
for k in EX_LEAVES:
    out[f"dense/mean/{k}"] = dm[k].numpy()

# three steps of each mode through the Session
cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **SMALL)
leaves, treedef = tree.flatten(TT.abstract_params(cfg))
start = tree.unflatten(treedef, [inp[f"param{i}"]
                                 for i in range(len(leaves))])
for name, (mode, mc) in MODES.items():
    run = api.RunConfig(mode=mode, momentum_correction=mc,
                        selection_backend="kernel", **RUN_KW)
    sess = api.Session(cfg, run, mesh=mesh)
    step = sess.step_fn
    assert sess.meta["n_workers"] == WORLD and sess.meta["mode"] == mode
    module = TT.from_jax_params(start, cfg, device="cpu")
    state, _ = sess.init_state(params=module.params)
    for t in range(STEPS):
        batch = {"tokens": torch.from_numpy(inp["tokens"][t]),
                 "labels": torch.from_numpy(inp["labels"][t])}
        state, metrics = step(state, batch)
        out[f"{name}/loss{t}"] = float(metrics["loss"])
    assert state["step"] == STEPS
    for part in ("params", "ef"):
        for i, x in enumerate(tree.leaves(state[part])):
            out[f"{name}/{part}{i}"] = x.detach().numpy()
    for i, x in enumerate(tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = x.numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants() -> str:
    return "".join(f"{name} = {globals()[name]!r}\n" for name in (
        "WORLD", "STEPS", "SMALL", "MODES", "RUN_KW", "EX_LEAVES", "EX_KS",
        "EX_BLOCK"))


def _exchange_inputs(rng):
    """Stacked (WORLD, ...) updates of two steps and a start residual."""
    out = {}
    for k, s in EX_LEAVES.items():
        out[f"e0/{k}"] = (0.05 * rng.standard_normal((WORLD,) + s)).astype(
            np.float32)
        for t in range(2):
            out[f"u{t}/{k}"] = rng.standard_normal((WORLD,) + s).astype(
                np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX subprocess and four gloo ranks, started together; returns
    (inputs, JAX results, per-rank port results)."""
    import dataclasses
    from repro.configs import base
    tmp = tmp_path_factory.mktemp("dist")
    cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                              **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, SMALL["vocab"], (STEPS, B, S + 1)).astype(
        np.int32)
    inp = {f"param{i}": np.asarray(p)
           for i, p in enumerate(jax.tree.leaves(params))}
    inp.update(tokens=toks[..., :-1], labels=toks[..., 1:],
               **_exchange_inputs(rng))
    np.savez(tmp / "in.npz", **inp)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _constants() + textwrap.dedent(JAX_SCRIPT),
         str(tmp / "in.npz"), str(tmp / "jax.npz")], env=env,
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    torch_env = dict(env, OMP_NUM_THREADS="1")
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _constants() + textwrap.dedent(RANK_SCRIPT),
             str(r), str(tmp / "store"), str(tmp / "in.npz"),
             str(tmp / f"rank{r}.npz")], env=torch_env,
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    jres = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return inp, jres, ranks


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("use_kernel", [0, 1])
def test_block_lags_distributed_matches_sim_bitwise(runs, use_kernel):
    inp, _, ranks = runs
    ex = TL.BlockLAGSExchange(ks=EX_KS, block_size=EX_BLOCK,
                              use_kernel=bool(use_kernel))
    e = {k: torch.from_numpy(inp[f"e0/{k}"]) for k in EX_LEAVES}
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"]) for k in EX_LEAVES}
        m, e = ex.exchange(u, e, None)
        for r, res in enumerate(ranks):
            for k in EX_LEAVES:
                tag = f"block{use_kernel}/{t}"
                np.testing.assert_array_equal(
                    _bits(res[f"{tag}/mean/{k}"]), _bits(m[k].numpy()),
                    err_msg=f"mean {k} rank {r} step {t}")
                np.testing.assert_array_equal(
                    _bits(res[f"{tag}/ef/{k}"]), _bits(e[k][r].numpy()),
                    err_msg=f"ef {k} rank {r} step {t}")


def test_kernel_backend_bitwise_equals_xla_distributed(runs):
    _, _, ranks = runs
    for res in ranks:
        for key in (k for k in res if k.startswith("block0/")):
            np.testing.assert_array_equal(
                _bits(res[key]), _bits(res[key.replace("block0", "block1")]),
                err_msg=key)
        assert any(np.abs(res[f"block1/1/ef/{k}"]).sum() > 0
                   for k in EX_LEAVES)            # the residual is live


def test_dense_distributed_mean_matches_sim(runs):
    inp, _, ranks = runs
    for k in EX_LEAVES:
        want = torch.from_numpy(inp[f"u0/{k}"]).mean(0).numpy()
        for res in ranks:
            np.testing.assert_allclose(res[f"dense/mean/{k}"], want,
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(MODES))
def test_three_steps_match_jax_build_train_step(runs, name):
    _, jres, ranks = runs
    got = ranks[0]
    np.testing.assert_allclose(
        [got[f"{name}/loss{t}"] for t in range(STEPS)],
        [jres[f"{name}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    n_params = len([k for k in got if k.startswith(f"{name}/params")])
    assert n_params == 12
    for i in range(n_params):
        key = f"{name}/params{i}"
        np.testing.assert_allclose(got[key], jres[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        for r, res in enumerate(ranks[1:], 1):   # replicated, exactly
            np.testing.assert_array_equal(res[key], got[key], err_msg=key)
    for part in ("ef", "mom"):
        keys = [k for k in jres if k.startswith(f"{name}/{part}")]
        assert len(keys) == (0 if (part == "ef" and name == "dense") or
                             (part == "mom" and name != "lags_dp_mc")
                             else 12)
        for key in keys:
            # the reference's (WORLD, ...) state; rank r holds row r
            for r, res in enumerate(ranks):
                np.testing.assert_allclose(res[key][0], jres[key][r],
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{key} rank {r}")
