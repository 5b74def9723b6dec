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
    the model's sums run in another order);
  * the pipelined step (``repro_torch.pipeline``): ``pipeline="wave"``
    (exchanges launched by autograd hooks inside backprop, ``wave_target_
    bytes=2048`` so that the leaf-granular strategies run several waves)
    equals ``"off"`` bit for bit in losses, parameters and residuals, 2
    steps, for ``dense``, ``lags_dp`` (xla and kernel) and ``slgs`` (one
    wave); ``"async1"`` reproduces the reference's exact sync prefix on
    one repeated batch (losses ``[L0, L0, L1, ≠ off's third]``); and 3
    steps of ``slgs``, ``lags_dp``/wave, ``lags_dp``/async1 (+ mc 0.9)
    and ``dense``/``slgs`` async1 + mc 0.9 (the pending updates are the
    velocity tensors, which the step then updates in place) match the
    reference's ``build_train_step`` at the tolerances above, the
    ``async1`` pending updates too;
  * the adaptive ratios: ``lags_dp`` under a schedule the reference
    planned (mixed ratios, planned-dense leaves among them; its JSON
    loaded by each package), ``off`` and in the reference's planned
    waves (``plan_waves``), 3 steps against the reference's
    ``build_train_step`` at the tolerances above;
  * key-needing compressors on the distributed surface: ``randk`` through
    ``slgs`` (the flat mesh) and ``randk`` / ``topk_sampled`` through
    ``lags_hier2`` (pod 2 × data 2; sparse and dense inner tier), two
    steps with each step's stream: every rank's draws, mean and residuals
    equal the simulation path's bit for bit (CPU generators on both);
  * ``autotune.profiler.profile_model`` of the real step over the four
    ranks (dense and lags_dp steps, the collective sweep): a profile the
    reference reads, whose fit and plan match the reference's;
  * the paper's LSTM (``paper_lstm_ptb``'s smoke config: the sLSTM stack
    with layer norm) through ``lags_dp`` (kernel backend, the config's
    ratio 250), 3 steps against the reference's ``build_train_step`` at
    the tolerances above.
"""
import os
import textwrap

import numpy as np
import pytest
from test_torch_spawn import COMPILE_ONCE, Lazy, Spawned, load

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
# against the reference: name -> (mode, mc, pipeline, one repeated batch)
PIPE_MODES = {"slgs": ("slgs", 0.0, "off", False),
              "lags_dp_wave": ("lags_dp", 0.0, "wave", False),
              "lags_dp_async1": ("lags_dp", 0.0, "async1", True),
              "lags_dp_async1_mc": ("lags_dp", 0.9, "async1", True),
              "dense_async1_mc": ("dense", 0.9, "async1", True),
              "slgs_async1_mc": ("slgs", 0.9, "async1", True)}
# wave == off, bitwise: name -> (mode, selection backend)
WAVE_PARITY = {"dense": ("dense", "xla"), "lags_dp_xla": ("lags_dp", "xla"),
               "lags_dp_kernel": ("lags_dp", "kernel"),
               "slgs": ("slgs", "kernel")}
WAVE_BYTES = 2048
# against the reference under its own schedule: name -> pipeline
SCHED_MODES = {"sched": "off", "sched_wave": "wave"}
# sampled exchanges: name -> (mode, compressor, pods, inner ratio)
SAMPLED = {"slgs_randk": ("slgs", "randk", 1, 1.0),
           "hier2_randk": ("lags_hier2", "randk", 2, 4.0),
           "hier2_sampled": ("lags_hier2", "topk_sampled", 2, 1.0)}
SAMPLE_SEED = 3
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
    step = compile_once(api.build_train_step(cfg, mesh, run)[0])
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
for name, (mode, mc, pipeline, fixed) in PIPE_MODES.items():
    run = api.RunConfig(mode=mode, momentum_correction=mc, donate=False,
                        pipeline=pipeline, wave_target_bytes=WAVE_BYTES,
                        **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    step = compile_once(step)
    state, _ = TR.init_state(cfg, mesh, method=mode, pipeline=pipeline,
                             momentum_correction=mc)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            b = 0 if fixed else t
            batch = {"tokens": inp["tokens"][b], "labels": inp["labels"][b]}
            state, metrics = step(state, batch)
            out[f"{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef", "pending"):
        for i, x in enumerate(jax.tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = np.asarray(x)
    out[f"{name}/n_waves"] = meta["waves"].n_waves if meta["waves"] else 0
from repro.autotune import schedule as JSCH
from repro.pipeline import buckets as JWB
sched = JSCH.Schedule.from_json(str(inp["schedule"]))
planned = JWB.WaveSchedule.from_json(str(inp["waves"]))
for name, pipeline in SCHED_MODES.items():
    run = api.RunConfig(mode="lags_dp", donate=False, pipeline=pipeline,
                        schedule=sched, waves=planned, **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    step = compile_once(step)
    state, _ = TR.init_state(cfg, mesh, method="lags_dp", pipeline=pipeline)
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
    out[f"{name}/n_waves"] = meta["waves"].n_waves if meta["waves"] else 0
    out[f"{name}/ks"] = np.asarray(jax.tree.leaves(meta["ks"]))
lcfg = base.get_smoke_config("paper_lstm_ptb")
run = api.RunConfig(mode="lags_dp", donate=False, **RUN_KW)
step = compile_once(api.build_train_step(lcfg, mesh, run)[0])
state, _ = TR.init_state(lcfg, mesh, method="lags_dp")
flat, treedef = jax.tree.flatten(state["params"])
state["params"] = jax.tree.unflatten(treedef, [
    jax.device_put(inp[f"lstm_param{i}"], x.sharding)
    for i, x in enumerate(flat)])
with compat.set_mesh(mesh):
    for t in range(STEPS):
        batch = {"tokens": inp["lstm_tokens"][t],
                 "labels": inp["lstm_labels"][t]}
        state, metrics = step(state, batch)
        out[f"lstm/loss{t}"] = float(metrics["loss"])
for part in ("params", "ef"):
    for i, x in enumerate(jax.tree.leaves(state[part])):
        out[f"lstm/{part}{i}"] = np.asarray(x)
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


# the pipelined steps and slgs
def snapshot(name, state):
    for part in ("params", "ef", "pending"):
        for i, x in enumerate(tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = x.detach().clone().numpy()
    for i, x in enumerate(tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = x.clone().numpy()


def train(name, steps, fixed, save_after, **kw):
    run = api.RunConfig(wave_target_bytes=WAVE_BYTES, **RUN_KW, **kw)
    sess = api.Session(cfg, run, mesh=mesh)
    module = TT.from_jax_params(start, cfg, device="cpu")
    state, _ = sess.init_state(params=module.params)
    for t in range(steps):
        b = 0 if fixed else t
        batch = {"tokens": torch.from_numpy(inp["tokens"][b]),
                 "labels": torch.from_numpy(inp["labels"][b])}
        state, metrics = sess.step_fn(state, batch)
        out[f"{name}/loss{t}"] = float(metrics["loss"])
        for p in tree.leaves(state["params"]):
            assert p.grad is None and not p._post_accumulate_grad_hooks
        if t + 1 == save_after:
            snapshot(name, state)
    waves = sess.meta["waves"]
    out[f"{name}/n_waves"] = waves.n_waves if waves else 0


for name, (mode, mc, pipeline, fixed) in PIPE_MODES.items():
    # async1: a 4th step shows the honest staleness after the prefix
    train(name, STEPS + (pipeline == "async1"), fixed, STEPS, mode=mode,
          momentum_correction=mc, pipeline=pipeline,
          selection_backend="xla" if mode == "slgs" else "kernel")
train("async1_off", STEPS, True, STEPS, mode="lags_dp",
      selection_backend="kernel")
for name, (mode, backend) in WAVE_PARITY.items():
    for pipeline in ("off", "wave"):
        train(f"parity/{name}/{pipeline}", 2, False, 2, mode=mode,
              selection_backend=backend, pipeline=pipeline)

# the adaptive ratios: the reference's schedule and planned waves
from repro_torch.autotune import profiler as TPR
from repro_torch.autotune import schedule as TSCH
from repro_torch.api import registry as TR
from repro_torch.pipeline import buckets as TWB
sched = TSCH.Schedule.from_json(str(inp["schedule"]))
planned = TWB.WaveSchedule.from_json(str(inp["waves"]))
for name, pipeline in SCHED_MODES.items():
    train(name, STEPS, False, STEPS, mode="lags_dp", pipeline=pipeline,
          schedule=sched, waves=planned, selection_backend="kernel")

# key-needing compressors: this rank's draws, means and residuals
pod_mesh = M.make_mesh(pod=2, device="cpu")
like = {k: torch.zeros(s) for k, s in EX_LEAVES.items()}
for name, (mode, comp, pods, ratio_inner) in SAMPLED.items():
    m = pod_mesh if pods > 1 else mesh
    ex = TR.build_exchange(TR.ExchangeSpec(
        mode=mode, params_like=like, ratio=8.0, compressor=comp, sim=False,
        n_workers=WORLD, ratio_inner=ratio_inner))
    e = ex.init(like)
    run = api.RunConfig(seed=SAMPLE_SEED)
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"][rank]) for k in EX_LEAVES}
        mean, e = ex.exchange(u, e, M.worker_axes(m, M.data_axis_names(m)),
                              key=run.key_at(t))
        for i, x in enumerate(tree.leaves(mean)):
            out[f"{name}/{t}/mean{i}"] = x.numpy()
        for i, x in enumerate(tree.leaves(e)):
            out[f"{name}/{t}/ef{i}"] = x.numpy()

# the autotune profile of the real step over the four ranks
prof = TPR.profile_model(cfg, mesh, seq=S, global_batch=B, iters=1,
                         comm_sizes=(4096, 1 << 16, 1 << 20))
out["profile"] = np.array(prof.to_json())

# the paper's LSTM: sLSTM blocks with layer norm, lags_dp
from repro_torch.configs import paper_lstm_ptb
lcfg = paper_lstm_ptb.smoke_config()
lleaves, ltreedef = tree.flatten(TT.abstract_params(lcfg))
sess = api.Session(lcfg, api.RunConfig(mode="lags_dp",
                                       selection_backend="kernel", **RUN_KW),
                   mesh=mesh)
module = TT.from_jax_params(tree.unflatten(ltreedef, [
    inp[f"lstm_param{i}"] for i in range(len(lleaves))]), lcfg, device="cpu")
state, _ = sess.init_state(params=module.params)
for t in range(STEPS):
    batch = {"tokens": torch.from_numpy(inp["lstm_tokens"][t]),
             "labels": torch.from_numpy(inp["lstm_labels"][t])}
    state, metrics = sess.step_fn(state, batch)
    out[f"lstm/loss{t}"] = float(metrics["loss"])
snapshot("lstm", state)
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants() -> str:
    return "".join(f"{name} = {globals()[name]!r}\n" for name in (
        "WORLD", "STEPS", "SMALL", "MODES", "RUN_KW", "EX_LEAVES", "EX_KS",
        "EX_BLOCK", "PIPE_MODES", "WAVE_PARITY", "WAVE_BYTES", "SCHED_MODES",
        "SAMPLED", "SAMPLE_SEED", "B", "S"))


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
    """One JAX subprocess and four gloo ranks, started together
    (``test_torch_spawn.Spawned``); results by index, each read when a
    test first needs it: (inputs, JAX results, per-rank port
    results)."""
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
    sched, waves = _reference_plan(cfg)
    inp.update(schedule=np.array(sched.to_json()),
               waves=np.array(waves.to_json()))
    lcfg = base.get_smoke_config("paper_lstm_ptb")
    lparams, _ = JT.init_model(jax.random.PRNGKey(1), lcfg)
    inp.update({f"lstm_param{i}": np.asarray(p)
                for i, p in enumerate(jax.tree.leaves(lparams))})
    ltoks = np.random.default_rng(13).integers(
        0, lcfg.vocab, (STEPS, B, S + 1)).astype(np.int32)
    inp.update(lstm_tokens=ltoks[..., :-1], lstm_labels=ltoks[..., 1:])
    np.savez(tmp / "in.npz", **inp)

    sp = Spawned(tmp, dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                           JAX_PLATFORMS="cpu"))
    # the reference's CPU code at LLVM's lowest optimization level, each
    # step compiled once, on one thread (``test_torch_spawn``)
    sp.start("jax", COMPILE_ONCE + _constants() + textwrap.dedent(JAX_SCRIPT),
             [tmp / "in.npz", tmp / "jax.npz"],
             XLA_FLAGS="--xla_force_host_platform_device_count=4")
    for r in range(WORLD):
        sp.start(f"rank{r}", _constants() + textwrap.dedent(RANK_SCRIPT),
                 [r, tmp / "store", tmp / "in.npz", tmp / f"rank{r}.npz"],
                 OMP_NUM_THREADS="1")

    def jax_results():
        sp.wait("jax")
        return load(tmp / "jax.npz")

    def rank_results():
        sp.wait(*(f"rank{r}" for r in range(WORLD)))
        return [load(tmp / f"rank{r}.npz") for r in range(WORLD)]
    try:
        yield Lazy(lambda: inp, jax_results, rank_results)
    finally:
        sp.close()


def _reference_plan(cfg):
    """The reference's P = 4 plan of the shrunken model on the paper's
    1 Gbps wire from an apportioned 10 ms backward (ratios 1 to 1000),
    and its planned waves (several at a 2 KiB target)."""
    from repro.autotune import planner, profiler
    from repro.core import comm_model as cm
    from repro.pipeline import waves as W
    leaves = profiler.apportion_backward(
        profiler.backprop_leaves(cfg, B * S / WORLD), 0.01)
    sched = planner.plan_schedule(leaves, WORLD, cm.ETH_1GBPS,
                                  arch="small", shape="test")
    waves = W.plan_waves(leaves, sched, WORLD, cm.ETH_1GBPS,
                         target_bytes=WAVE_BYTES)
    return sched, waves


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("use_kernel", [0, 1])
def test_block_lags_distributed_matches_sim_bitwise(runs, use_kernel):
    inp, ranks = runs[0], runs[2]
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
    ranks = runs[2]
    for res in ranks:
        for key in (k for k in res if k.startswith("block0/")):
            np.testing.assert_array_equal(
                _bits(res[key]), _bits(res[key.replace("block0", "block1")]),
                err_msg=key)
        assert any(np.abs(res[f"block1/1/ef/{k}"]).sum() > 0
                   for k in EX_LEAVES)            # the residual is live


def test_dense_distributed_mean_matches_sim(runs):
    inp, ranks = runs[0], runs[2]
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


def _bitwise_equal(res: dict, prefix_a: str, prefix_b: str,
                   what: str) -> int:
    """Every array under ``prefix_a`` equals its ``prefix_b`` twin bit
    for bit (the wave counts aside); returns how many were compared."""
    def keys(prefix):
        return sorted(k[len(prefix):] for k in res
                      if k.startswith(prefix) and k != prefix + "n_waves")
    assert keys(prefix_a) == keys(prefix_b), what
    for k in keys(prefix_a):
        np.testing.assert_array_equal(_bits(res[prefix_a + k]),
                                      _bits(res[prefix_b + k]),
                                      err_msg=f"{what} {k}")
    return len(keys(prefix_a))


@pytest.mark.parametrize("name", list(WAVE_PARITY))
def test_wave_equals_off_bitwise_on_four_ranks(runs, name):
    """Losses, parameters and EF residuals of 2 steps: ``wave`` (hooks
    inside backprop) == ``off`` bit for bit on every rank, with several
    waves for the leaf-granular strategies and one for slgs."""
    ranks = runs[2]
    for r, res in enumerate(ranks):
        n = res[f"parity/{name}/wave/n_waves"]
        assert (n == 1) if name == "slgs" else (n > 1), n
        assert res[f"parity/{name}/off/n_waves"] == 0
        count = _bitwise_equal(res, f"parity/{name}/off/",
                               f"parity/{name}/wave/", f"{name} rank {r}")
        assert count == 2 + 12 * (1 if name == "dense" else 2)


def test_async1_reproduces_the_exact_sync_prefix(runs):
    """One repeated batch: step 0 exchanges the zero pending update
    (params untouched), step 1 applies step 0's exchange, so the losses
    are ``[L0, L0, L1]`` against ``off``'s ``[L0, L1, L2]``; step 3 runs
    on one-step-stale updates and leaves ``off``'s trajectory."""
    ranks = runs[2]
    for res in ranks:
        a = [res[f"lags_dp_async1/loss{t}"] for t in range(STEPS + 1)]
        off = [res[f"async1_off/loss{t}"] for t in range(STEPS)]
        assert all(np.isfinite(a))
        assert a[0] == off[0] and a[1] == off[0]
        assert a[2] == off[1]
        assert a[3] != off[2]
        assert any(k.startswith("lags_dp_async1/pending") for k in res)
        assert not any(k.startswith("async1_off/pending") for k in res)


@pytest.mark.parametrize("name", list(PIPE_MODES))
def test_pipelined_and_slgs_three_steps_match_jax(runs, name):
    """3 steps against the reference's ``build_train_step``: losses rtol
    1e-5; parameters, residuals, velocities and pending updates rtol
    1e-4 atol 1e-5; parameters equal on every rank, bit for bit."""
    _, jres, ranks = runs
    got = ranks[0]
    np.testing.assert_allclose(
        [got[f"{name}/loss{t}"] for t in range(STEPS)],
        [jres[f"{name}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    assert got[f"{name}/n_waves"] == jres[f"{name}/n_waves"]
    for i in range(12):
        key = f"{name}/params{i}"
        np.testing.assert_allclose(got[key], jres[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[key], got[key], err_msg=key)
    mode, mc, pipeline, _ = PIPE_MODES[name]
    for part, want in (("ef", 0 if mode == "dense" else 12),
                       ("mom", 12 if mc else 0),
                       ("pending", 12 if pipeline == "async1" else 0)):
        keys = [k for k in jres if k.startswith(f"{name}/{part}")]
        assert len(keys) == want, (part, keys)
        for key in keys:
            for r, res in enumerate(ranks):
                np.testing.assert_allclose(res[key][0], jres[key][r],
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("name", list(SCHED_MODES))
def test_scheduled_lags_dp_three_steps_match_jax(runs, name):
    """The reference's schedule (mixed ratios, dense leaves among them)
    through both packages' distributed ``lags_dp``, ``off`` and in the
    planned waves: the same per-leaf k's and wave count, losses rtol
    1e-5, parameters and residuals rtol 1e-4 atol 1e-5, parameters equal
    on every rank, bit for bit."""
    inp, jres, ranks = runs
    from repro_torch.autotune import schedule as TSCH
    sched = TSCH.Schedule.from_json(str(inp["schedule"]))
    ratios = {lp.ratio for lp in sched.leaves}
    assert 1.0 in ratios and len(ratios) > 2, ratios
    import dataclasses
    from repro_torch import tree as ttree
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **SMALL)
    assert ttree.leaves(sched.ks_tree(TT.abstract_params(cfg))) == [
        int(k) for k in jres[f"{name}/ks"]]
    got = ranks[0]
    np.testing.assert_allclose(
        [got[f"{name}/loss{t}"] for t in range(STEPS)],
        [jres[f"{name}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    assert got[f"{name}/n_waves"] == jres[f"{name}/n_waves"]
    assert (jres[f"{name}/n_waves"] > 1) == (name == "sched_wave")
    for part, n in (("params", 12), ("ef", 12)):
        keys = [k for k in jres if k.startswith(f"{name}/{part}")]
        assert len(keys) == n
        for key in keys:
            for r, res in enumerate(ranks):
                want = jres[key] if part == "params" else jres[key][r]
                have = res[key] if part == "params" else res[key][0]
                np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{key} rank {r}")
            if part == "params":
                for res in ranks[1:]:
                    np.testing.assert_array_equal(res[key], got[key])


@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_exchanges_draw_as_the_simulation_path(runs, name):
    """Each rank's ``randk`` / ``topk_sampled`` picks (its stream folds
    the step, the leaf and its worker coordinate; the cross-pod tier the
    pod's) give the simulation path's mean and this worker's residuals
    bit for bit, two steps."""
    from repro_torch import api as tapi
    from repro_torch import tree as ttree
    from repro_torch.api import registry as TR
    inp, ranks = runs[0], runs[2]
    mode, comp, pods, ratio_inner = SAMPLED[name]
    like = {k: torch.zeros(s) for k, s in EX_LEAVES.items()}
    ex = TR.build_exchange(TR.ExchangeSpec(
        mode=mode, params_like=like, ratio=8.0, compressor=comp, sim=True,
        n_workers=WORLD, n_inner=WORLD // pods, ratio_inner=ratio_inner))
    e = ex.init({k: torch.zeros((WORLD,) + s) for k, s in EX_LEAVES.items()})
    run = tapi.RunConfig(seed=SAMPLE_SEED)
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"]) for k in EX_LEAVES}
        mean, e = ex.exchange(u, e, None, key=run.key_at(t))
        for r, res in enumerate(ranks):
            for i, x in enumerate(ttree.leaves(mean)):
                np.testing.assert_array_equal(
                    _bits(res[f"{name}/{t}/mean{i}"]), _bits(x.numpy()),
                    err_msg=f"{name} mean {i} rank {r} step {t}")
            for i, x in enumerate(ttree.leaves(e)):
                np.testing.assert_array_equal(
                    _bits(res[f"{name}/{t}/ef{i}"]), _bits(x[r].numpy()),
                    err_msg=f"{name} residual {i} rank {r} step {t}")
    assert any(float(x.abs().sum()) > 0 for x in ttree.leaves(e))


def test_profile_of_the_real_step_over_four_ranks(runs):
    """``profile_model`` over the four gloo ranks: a profile the
    reference parses, with measured dense and lags_dp steps, FLOPs and
    device-memory bytes of the dense step, wire samples of both
    collectives at every size over 4 workers; the fit (the device-memory
    rate the dense step's bytes over its time) and the plan over it equal
    the reference's."""
    from repro.autotune import costfit as JF
    from repro.autotune import planner as JP
    from repro.autotune import profiler as JPR
    from repro.core import comm_model as JCM
    from repro_torch.autotune import costfit as TF
    from repro_torch.autotune import planner as TP
    from repro_torch.autotune import profiler as TPR
    from repro_torch.core import comm_model as TCM
    ranks = runs[2]
    for res in ranks:
        prof = TPR.ModelProfile.from_json(str(res["profile"]))
        jprof = JPR.ModelProfile.from_json(str(res["profile"]))
        assert prof.n_workers == WORLD and prof.mesh_shape == (WORLD,)
        assert prof.t_step_dense > 0 and prof.t_step_lags > 0
        assert prof.flops_per_step > 0 and prof.hbm_bytes_per_step > 0
        assert prof.tokens_per_worker == B * S / WORLD
        assert [(c.kind, c.nbytes, c.p) for c in prof.comm_samples] == [
            (k, float(n), WORLD) for n in (4096, 1 << 16, 1 << 20)
            for k in ("allgather", "allreduce")]
        assert len(prof.leaves) == 12
        base = dict(name="b", alpha=1e-5, beta=1e-10, flops=1e12,
                    hbm_bw=1e11)
        thw = TF.fit_hardware(prof, base=TCM.Hardware(**base))
        jhw = JF.fit_hardware(jprof, base=JCM.Hardware(**base))
        assert thw.alpha > 0 and thw.beta > 0
        assert thw.hbm_bw == jhw.hbm_bw == \
            prof.hbm_bytes_per_step / prof.t_step_dense
        assert abs(thw.alpha - jhw.alpha) <= 1e-12 * jhw.alpha
        assert abs(thw.beta - jhw.beta) <= 1e-12 * jhw.beta
        assert TP.plan_schedule(prof.leaves, WORLD, thw).to_json() == \
            JP.plan_schedule(jprof.leaves, WORLD, jhw).to_json()


def test_paper_lstm_three_steps_match_jax_build_train_step(runs):
    """The paper's LSTM (smoke: 2 sLSTM blocks with layer norm, 11
    leaves) through the distributed ``lags_dp`` over four ranks: losses
    rtol 1e-5, parameters and each rank's residuals rtol 1e-4 atol 1e-5
    of the reference's ``build_train_step``; parameters equal on every
    rank, bit for bit."""
    _, jres, ranks = runs
    got = ranks[0]
    np.testing.assert_allclose(
        [got[f"lstm/loss{t}"] for t in range(STEPS)],
        [jres[f"lstm/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    for part in ("params", "ef"):
        keys = [k for k in jres if k.startswith(f"lstm/{part}")]
        assert len(keys) == 11
        for key in keys:
            for r, res in enumerate(ranks):
                want = jres[key] if part == "params" else jres[key][r]
                have = res[key] if part == "params" else res[key][0]
                np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{key} rank {r}")
                if part == "params":
                    np.testing.assert_array_equal(res[key], got[key])
