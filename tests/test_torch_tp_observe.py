"""The rest of the stack on a 'model' axis: the health quantities, the
re-planning controller, ``profile_model`` and ``Session.run``'s
publisher on ``DTensor`` parameters, against the reference's
``make_host_mesh(data=2, model=2)``; and one re-planning decision for
the whole mesh.

One spawn: four gloo ranks at ``M.make_mesh(model=2)`` (data 2 × model
2, the SMALL TinyLlama of ``test_torch_tp.py``, f32), two more gloo
ranks on a data-only mesh of two, and the reference on the 2 × 2 host
mesh (4 host devices) in two JAX subprocesses side by side.

Contracts:
  * the health quantities (``health_delta``, ``health_delta_max``,
    ``health_ef_energy_*``) of 2 steps of ``lags_dp``, ``lags_hier2`` and
    ``lags_hier`` under ``off`` and ``wave`` equal the reference's within
    rtol ``HEALTH_RTOL`` = 1e-5 (atol 1e-7): sums of squares of each
    rank's chunks summed over 'model' (and 'data' under ``lags_hier``'s
    FSDP) in another order than XLA's; δ takes the full leaf's d and k,
    which a chunk's d would move by more than that (checked on the
    budgets); the values are the same on every rank;
  * a ``ReplanController`` on the 2 × 2 mesh, its telemetry from a
    ``FakeTraceBackend`` whose wire degrades after the first step and a
    cadence trigger of 2, makes the reference's ``SwapEvent``s (step,
    swapped, trigger, fit) and schedule, its three losses within rtol
    1e-5 (inside chip_smoke's ``TP_LOSS_RTOL`` of 1e-4); every rank the
    same events; ``save_state``/``restore_state`` round-trip on the mesh
    and the restored schedule is live;
  * on a data-only world of two whose ranks probe different wires and
    whose trigger fires on rank 1 only, both ranks re-plan at the same
    step from rank 0's wire, log the same ``SwapEvent``s, swap and keep
    bitwise-equal parameters (the tree before this repair: rank 1
    re-planned alone, and the ranks' histories differed);
  * ``Session.run`` on 2 × 2 with a ``StreamPublisher`` (``topk_block``)
    cuts every packet, full and delta, bitwise the packet a one-card
    publisher cuts from ``dtensor.gather`` of the parameters; the
    publisher keeps chunks (the residual a rank's chunk of each leaf);
    rank 0 writes the packet files, and a ``ServeSession`` on 'model'
    applies them on every rank to the published parameters, bit for bit;
  * ``profile_model`` on 2 × 2 counts data workers (2), carries the
    mesh's shape, and per card FLOPs and bytes: the bytes within
    ``BYTES_BAND`` of the reference's ``cost_analysis()`` of its
    partitioned dense step (per device), the FLOPs within
    ``FLOPS_BAND``; ``costfit.fit_hardware`` fits the same ``hbm_bw``
    from the port's profile and from the reference's
    ``ModelProfile.from_json`` of it.
"""
import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest
from test_torch_spawn import COMPILE_ONCE, Lazy, Spawned, load

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import transformer as JT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA, MODEL, STEPS, B, S = 2, 2, 2, 8, 16
WORLD = DATA * MODEL
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, compression_ratio=8.0, dtype="float32",
             param_dtype="float32")
RUN_KW = dict(lr=0.1, chunk=8, loss_chunk=8, block_size=64,
              ratio_inner=4.0, inner_compressor="topk_block")
HEALTH = {f"{mode}/{pipeline}": (mode, pipeline)
          for mode in ("lags_dp", "lags_hier2", "lags_hier")
          for pipeline in ("off", "wave")}
HEALTH_RTOL, HEALTH_ATOL = 1e-5, 1e-7
WAVE_BYTES = 2048
# the controller: 3 steps, cadence 2, the wire degraded after step 1
CTL_STEPS, CADENCE = 3, 2
# the reference's TPU presets, as numbers both packages are given
FAST = dict(name="tpu_v5e", alpha=1e-6, beta=1.0 / 50e9, flops=197e12)
DCN = dict(name="tpu_dcn", alpha=10e-6, beta=1.0 / 25e9, flops=197e12)
SLOW = dict(name="degraded", alpha=50e-3, beta=1e-6, flops=197e12)
# the reference's work in two subprocesses run side by side: the health
# modes, the controller ("ctl") and the cost analysis ("cost") of each
JAX_PARTS = (("lags_dp", "lags_hier2", "cost"), ("lags_hier", "ctl"))
# the publisher: a packet every step of 3, a budget of an eighth of
# the model's bytes
PUB_STEPS = 3
# the port's per-card bytes and FLOPs of the dense step over the
# reference's per-device cost_analysis() at 2 x 2: 2.757 and 1.837
# measured (at data 1 x model 1: 2.195 and 1.840; see the test)
BYTES_BAND = (1.5, 3.2)
FLOPS_BAND = (1.6, 2.1)

CONTROLLER = '''
def synth(pkg_cm, prof, hw, p):
    out = []
    for n in (1 << 12, 1 << 16, 1 << 20):
        out.append(prof.CommSample("allgather", float(n), p,
                                   pkg_cm.allgather_time(float(n), p, hw)))
        out.append(prof.CommSample("allreduce", float(n), p,
                                   pkg_cm.allreduce_time(float(n), p, hw)))
    return out


def controller_run(RC, OT, TG, CM, PR, ctl_cfg, mesh, run, state, step_at,
                   out, name):
    wires = {"flat": CM.Hardware(**FAST)}
    rcfg = RC.RuntimeConfig(replan_every=CADENCE, fence_every=1,
                            min_step_samples=1,
                            hw_base=CM.Hardware(**FAST),
                            hw_base_outer=CM.Hardware(**DCN))
    ctl = RC.ReplanController(
        ctl_cfg, mesh, rcfg=rcfg, run=run,
        comm_probe=lambda m, a: synth(CM, PR, CM.Hardware(**SLOW), DATA),
        triggers=(TG.CadenceTrigger(CADENCE),))
    fake = OT.FakeTraceBackend(
        PR.apportion_backward(ctl._leaf_template, 0.040), wires=wires,
        tier_workers={"flat": DATA}, t_forward=0.020,
        schedule_fn=lambda: ctl.schedule)
    ctl.trace_source = fake.capture
    for t in range(CTL_STEPS):
        if t == 1:
            wires["flat"] = CM.Hardware(**SLOW)
        state, metrics = step_at(ctl, state, t)
        out[f"{name}/loss{t}"] = float(metrics["loss"])
    out[f"{name}/history"] = np.array(json.dumps(
        [dataclasses.asdict(e) for e in ctl.history]))
    out[f"{name}/schedule"] = np.array(ctl.schedule.to_json())
    out[f"{name}/n_workers"] = np.array(
        [ctl.meta["n_workers"]] + list(ctl.tier_workers))
    return ctl, state
'''

JAX_SCRIPT = """
import dataclasses, json, sys
import jax, numpy as np
from repro import api, compat
from repro.autotune import profiler as PR
from repro.configs import base
from repro.core import comm_model as CM
from repro.launch import mesh as M, specs as SP, train as TR
from repro.observe import trace as OT, triggers as TG
from repro.runtime import controller as RC

inp = np.load(sys.argv[1])
part = JAX_PARTS[int(sys.argv[3])]
cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                          **SMALL)
mesh = M.make_host_mesh(data=DATA, model=MODEL)
out = {}


def start_state(c, mode, pipeline="off"):
    state, _ = TR.init_state(c, mesh, method=mode, pipeline=pipeline)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    return state


def batch_at(t):
    return {"tokens": inp["tokens"][t], "labels": inp["labels"][t]}


for name, (mode, pipeline) in HEALTH.items():
    if mode not in part:
        continue
    run = api.RunConfig(mode=mode, pipeline=pipeline, health_every=1,
                        donate=False, wave_target_bytes=WAVE_BYTES,
                        **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    step = compile_once(step)
    state = start_state(cfg, mode, pipeline)
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            state, metrics = step(state, batch_at(t))
            for k, v in metrics.items():
                out[f"{name}/{t}/{k}"] = np.asarray(v)
    out[f"{name}/ks"] = np.array([int(k) for k in jax.tree.leaves(
        meta["ks"])])

ctl_cfg = dataclasses.replace(cfg, train_mode="lags_dp",
                              compression_ratio=1.0)


def step_at(ctl, state, t):
    with compat.set_mesh(mesh):
        return ctl.step(state, batch_at(t))


if "ctl" in part:
    controller_run(RC, OT, TG, CM, PR, ctl_cfg, mesh,
                   api.RunConfig(**RUN_KW), start_state(ctl_cfg, "lags_dp"),
                   step_at, out, "ctl")
if "cost" in part:
    batch = SP.concrete_batch(cfg, base.InputShape("profile", S, B, "train"))
    _, cost, _ = PR._time_step(cfg, mesh, batch, method="dense", seq=S,
                               iters=1)
    out["cost/bytes"] = float(cost["bytes accessed"])
    out["cost/flops"] = float(cost["flops"])
np.savez(sys.argv[2], **out)
print("OK jax")
"""

RANK_SCRIPT = """
import dataclasses, json, os, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import api, tree
from repro_torch.autotune import profiler as PR
from repro_torch.configs import base, tinyllama_1_1b
from repro_torch.core import comm_model as CM
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT
from repro_torch.observe import trace as OT, triggers as TG
from repro_torch.runtime import controller as RC
from repro_torch.sharding import dtensor as D
from repro_torch.stream import StreamPublisher, ServeSession
from repro_torch.stream import codec as CD

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", WORLD, rank, device="cpu")
mesh = M.make_mesh(model=MODEL, device="cpu")
assert mesh.mesh_dim_names == ("data", "model")
cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **SMALL)
leaves, treedef = tree.flatten(TT.abstract_params(cfg))
start = tree.unflatten(treedef, [inp[f"param{i}"]
                                 for i in range(len(leaves))])
out = {}


def params():
    return TT.from_jax_params(start, cfg, device="cpu").params


def batch_at(t):
    return {"tokens": torch.from_numpy(inp["tokens"][t]),
            "labels": torch.from_numpy(inp["labels"][t])}


# the health quantities
for name, (mode, pipeline) in HEALTH.items():
    sess = api.Session(cfg, api.RunConfig(
        mode=mode, pipeline=pipeline, health_every=1,
        wave_target_bytes=WAVE_BYTES, **RUN_KW), mesh=mesh)
    state, _ = sess.init_state(params=params())
    for t in range(STEPS):
        state, metrics = sess.step_fn(state, batch_at(t))
        for k, v in metrics.items():
            out[f"{name}/{t}/{k}"] = v.numpy()
    out[f"{name}/ks"] = np.array([int(k) for k in tree.leaves(
        sess.meta["ks"])])
    out[f"{name}/d"] = np.array([int(np.prod(x.shape))
                                 for x in tree.leaves(state["params"])])
    out[f"{name}/d_local"] = np.array([D.local(x).numel()
                                       for x in tree.leaves(state["params"])])

# the controller: the live state carries over a swap, and its state
# round-trips
ctl_cfg = dataclasses.replace(cfg, train_mode="lags_dp",
                              compression_ratio=1.0)
sess = api.Session(ctl_cfg, api.RunConfig(mode="lags_dp", **RUN_KW),
                   mesh=mesh)
state, _ = sess.init_state(params=params())
ctl, state = controller_run(
    RC, OT, TG, CM, PR, ctl_cfg, mesh, api.RunConfig(**RUN_KW), state,
    lambda ctl, s, t: ctl.step(s, batch_at(t)), out, "ctl")
out["ctl/dtensor"] = np.array(all(D.is_dtensor(p)
                                  for p in tree.leaves(state["params"])))
path = os.path.join(os.path.dirname(out_path), f"runtime{rank}")
ctl.save_state(path)
ctl2 = RC.ReplanController(ctl_cfg, mesh, rcfg=ctl.rcfg,
                           run=api.RunConfig(**RUN_KW))
ctl2.restore_state(path)
out["ctl/restored"] = np.array(
    ctl2.schedule.to_json() == ctl.schedule.to_json()
    and ctl2.history == ctl.history
    and ctl2.telemetry.step_samples() == ctl.telemetry.step_samples()
    and tree.leaves(ctl2.meta["ks"]) == tree.leaves(ctl.meta["ks"]))
state, metrics = ctl2.step_fn(state, batch_at(0))
out["ctl/restored_loss"] = float(metrics["loss"])
del ctl, ctl2


# Session.run with a publisher: each packet against a one-card
# publisher fed the gathered parameters
class Both:
    def __init__(self, pub, one):
        self.pub, self.one, self.pairs = pub, one, []

    def maybe_publish(self, step, params):
        pkt = self.pub.maybe_publish(step, params)
        ref = self.one.maybe_publish(step, D.gather(params))
        self.pairs.append((pkt, ref))
        return pkt


sess = api.Session(cfg, api.RunConfig(mode="lags_dp", **RUN_KW), mesh=mesh)
state, _ = sess.init_state(params=params())
pub_dir = os.path.join(os.path.dirname(out_path), "packets")
budget = sum(4 * x.numel() for x in tree.leaves(state["params"])) // 8
kw = dict(every=1, budget_bytes=budget, compressor="topk_block")
both = Both(StreamPublisher(state["params"], out_dir=pub_dir, **kw),
            StreamPublisher(D.gather(state["params"]), **kw))
state, hist = sess.run(batch_at, PUB_STEPS, state=state, publisher=both,
                       print_fn=lambda *a: None)
same = []
for pkt, ref in both.pairs:
    ok = (pkt.kind, pkt.nbytes, pkt.version, pkt.fingerprint) == (
        ref.kind, ref.nbytes, ref.version, ref.fingerprint)
    ok = ok and sorted(pkt.payload) == sorted(ref.payload)
    for key, entry in pkt.payload.items():
        want = ref.payload[key]
        ok = ok and sorted(entry) == sorted(want) and all(
            entry[f].dtype == want[f].dtype and torch.equal(
                entry[f].contiguous().view(torch.uint8),
                want[f].contiguous().view(torch.uint8)) for f in entry)
    same.append(ok)
out["pub/same"] = np.array(same)
out["pub/kinds"] = np.array([p.kind for p, _ in both.pairs])
out["pub/rows"] = np.array([r.get("publish", {}).get("kind", "")
                            for r in hist])
out["pub/residual_local"] = np.array(
    all(both.pub.residual[k].numel() == D.local(x).numel()
        for k, x in CD.leaf_items(state["params"])))
out["pub/published_dtensor"] = np.array(all(
    D.is_dtensor(x) for x in tree.leaves(both.pub.published)))
out["pub/files"] = np.array(len(both.pub.packet_paths))
published = D.gather(both.pub.published)
out["pub/published_is_one"] = np.array(all(torch.equal(a, b) for a, b in zip(
    tree.leaves(published), tree.leaves(both.one.published))))
dist.barrier()
serve = ServeSession(cfg, base.InputShape("serve", 8, 2, "decode"),
                     params(), mesh=mesh, chunk=8)
status = [serve.apply_packet_file(CD.packet_path(pub_dir, v))
          for v in range(1, PUB_STEPS + 1)]
out["serve/status"] = np.array(status)
out["serve/same"] = np.array(all(torch.equal(a, b) for a, b in zip(
    tree.leaves(D.gather(serve.params)), tree.leaves(published))))
toks = serve.generate(torch.from_numpy(inp["tokens"][0][:2, :8]), 2)
out["serve/tokens"] = toks.numpy()

# profile_model on the 'model' axis
prof = PR.profile_model(cfg, mesh, seq=S, global_batch=B, iters=1,
                        comm_sizes=(4096,))
out["prof/json"] = np.array(prof.to_json())
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""

AGREE_SCRIPT = """
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import api, tree
from repro_torch.autotune import profiler as PR
from repro_torch.configs import tinyllama_1_1b
from repro_torch.core import comm_model as CM
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT
from repro_torch.runtime import controller as RC

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", 2, rank, device="cpu")
mesh = M.make_mesh(device="cpu")
cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **SMALL,
                          train_mode="lags_dp")
cfg = dataclasses.replace(cfg, compression_ratio=1.0)
leaves, treedef = tree.flatten(TT.abstract_params(cfg))
start = tree.unflatten(treedef, [inp[f"param{i}"]
                                 for i in range(len(leaves))])


class RankOne:
    # fires at step 2 on rank 1 only
    name = "rank_one"

    def due(self, ctx):
        return rank == 1 and ctx.step == 2

    def notify_replan(self, ctx, event):
        pass


# each rank its own wire: rank 0 a degraded one, rank 1 a healthy one
wire = CM.Hardware(**(SLOW if rank == 0 else FAST))
sess = api.Session(cfg, api.RunConfig(mode="lags_dp", **RUN_KW), mesh=mesh)
state, _ = sess.init_state(params=TT.from_jax_params(start, cfg,
                                                     device="cpu").params)
ctl = sess.controller(
    rcfg=RC.RuntimeConfig(replan_every=0, fence_every=1, min_step_samples=1,
                          hw_base=CM.Hardware(**FAST)),
    comm_probe=lambda m, a: synth(CM, PR, wire, 2), triggers=(RankOne(),))
out = {}
for t in range(4):
    batch = {"tokens": torch.from_numpy(inp["tokens"][t % 2]),
             "labels": torch.from_numpy(inp["labels"][t % 2])}
    state, metrics = ctl.step(state, batch)
    out[f"loss{t}"] = float(metrics["loss"])
out["history"] = np.array(json.dumps(
    [dataclasses.asdict(e) for e in ctl.history]))
out["schedule"] = np.array(ctl.schedule.to_json()
                           if ctl.schedule is not None else "")
for i, x in enumerate(tree.leaves(state["params"])):
    out[f"params{i}"] = x.detach().numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants() -> str:
    return "".join(f"{name} = {globals()[name]!r}\n" for name in (
        "DATA", "MODEL", "WORLD", "STEPS", "B", "S", "SMALL", "RUN_KW",
        "HEALTH", "WAVE_BYTES", "CTL_STEPS", "CADENCE", "FAST", "DCN",
        "SLOW", "PUB_STEPS", "JAX_PARTS"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two JAX subprocesses (``JAX_PARTS``), four gloo ranks at 2 × 2 and
    two on a data-only mesh, started together (``test_torch_spawn.Spawned``);
    results by index, each read when a test first needs it: (JAX
    results, the 2 × 2 ranks' results, the data-only ranks')."""
    from repro.configs import base
    tmp = tmp_path_factory.mktemp("tp_observe")
    cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                              **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(31)
    toks = rng.integers(0, SMALL["vocab"], (CTL_STEPS, B, S + 1)).astype(
        np.int32)
    inp = {f"param{i}": np.asarray(p)
           for i, p in enumerate(jax.tree.leaves(params))}
    inp.update(tokens=toks[..., :-1], labels=toks[..., 1:])
    np.savez(tmp / "in.npz", **inp)

    head = _constants() + textwrap.dedent(CONTROLLER)
    sp = Spawned(tmp, dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                           JAX_PLATFORMS="cpu"))
    for i in range(len(JAX_PARTS)):
        sp.start(f"jax{i}", COMPILE_ONCE + head + textwrap.dedent(JAX_SCRIPT),
                 [tmp / "in.npz", tmp / f"jax{i}.npz", i],
                 XLA_FLAGS="--xla_backend_optimization_level=0 "
                           "--xla_cpu_multi_thread_eigen=false "
                           f"--xla_force_host_platform_device_count={WORLD}")
    for r in range(WORLD):
        sp.start(f"rank{r}", head + textwrap.dedent(RANK_SCRIPT),
                 [r, tmp / "store", tmp / "in.npz", tmp / f"rank{r}.npz"],
                 OMP_NUM_THREADS="1")
    for r in range(2):
        sp.start(f"agree{r}", head + textwrap.dedent(AGREE_SCRIPT),
                 [r, tmp / "store2", tmp / "in.npz", tmp / f"agree{r}.npz"],
                 OMP_NUM_THREADS="1")

    def jax_results():
        out = {}
        for i in range(len(JAX_PARTS)):
            sp.wait(f"jax{i}")
            out.update(load(tmp / f"jax{i}.npz"))
        return out

    def ranks(prefix, n):
        def results():
            sp.wait(*(f"{prefix}{r}" for r in range(n)))
            return [load(tmp / f"{prefix}{r}.npz") for r in range(n)]
        return results
    try:
        yield Lazy(jax_results, ranks("rank", WORLD), ranks("agree", 2))
    finally:
        sp.close()


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(HEALTH))
def test_health_matches_the_reference(runs, name):
    """Each health key of 2 steps within rtol 1e-5 (atol 1e-7) of the
    reference's, the same keys, and the same numbers on every rank."""
    jres, ranks = runs[0], runs[1]
    got = ranks[0]
    for t in range(STEPS):
        keys = sorted(k[len(f"{name}/{t}/"):] for k in jres
                      if k.startswith(f"{name}/{t}/health"))
        assert keys == sorted(k[len(f"{name}/{t}/"):] for k in got
                              if k.startswith(f"{name}/{t}/health"))
        assert "health_delta" in keys and "health_delta_max" in keys
        assert any(k.startswith("health_ef_energy") for k in keys)
        np.testing.assert_allclose(got[f"{name}/{t}/loss"],
                                   jres[f"{name}/{t}/loss"], rtol=1e-5)
        for k in keys:
            np.testing.assert_allclose(
                got[f"{name}/{t}/{k}"], jres[f"{name}/{t}/{k}"],
                rtol=HEALTH_RTOL, atol=HEALTH_ATOL, err_msg=f"{k} step {t}")
            for res in ranks[1:]:
                np.testing.assert_array_equal(res[f"{name}/{t}/{k}"],
                                              got[f"{name}/{t}/{k}"])
        assert float(got[f"{name}/{t}/health_delta_max"]) > 0.0


def test_delta_takes_the_full_leaf_d_and_k(runs):
    """Eq. 20's ``1 - k/d`` over a rank's chunk (d/2 on a sharded leaf)
    would move δ by more than the tolerance on the sharded leaves: the
    agreement above holds the full leaf's d and k."""
    jres, got = runs[0], runs[1][0]
    name = "lags_dp/off"
    ks, d, d_local = (got[f"{name}/{f}"] for f in ("ks", "d", "d_local"))
    np.testing.assert_array_equal(ks, jres[f"{name}/ks"])
    sharded = d_local < d
    assert sharded.sum() >= len(d) // 2
    full = 1.0 - np.minimum(ks, d) / d
    chunk = 1.0 - np.minimum(ks, d_local) / d_local
    moved = np.abs(full / np.maximum(chunk, 1e-30) - 1.0)[sharded]
    assert moved.min() > 100 * HEALTH_RTOL, moved


def test_controller_matches_the_reference(runs):
    """The same ``SwapEvent``s (step, swapped, trigger, fit; predictions
    to rel 1e-9), the same schedule after the swap, three losses within
    rtol 1e-5; every rank the same events and schedule; two data workers
    (and tier workers (2, 2)); the parameters stay ``DTensor``s."""
    jres, ranks = runs[0], runs[1]
    want = json.loads(str(jres["ctl/history"]))
    assert [e["swapped"] for e in want] == [True]
    for res in ranks:
        got = json.loads(str(res["ctl/history"]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("step", "swapped", "trigger", "hw_name"):
                assert g[k] == w[k], k
            for k in ("improvement", "t_pred_current", "t_pred_candidate",
                      "overlap"):
                assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-15), k
        t, j = (json.loads(str(x["ctl/schedule"])) for x in (res, jres))
        assert [(lp["name"], lp["d"], lp["ratio"], lp["k"])
                for lp in t["leaves"]] == [
            (lp["name"], lp["d"], lp["ratio"], lp["k"])
            for lp in j["leaves"]]
        assert t["n_workers"] == j["n_workers"] == DATA
        np.testing.assert_allclose(
            [res[f"ctl/loss{t}"] for t in range(CTL_STEPS)],
            [jres[f"ctl/loss{t}"] for t in range(CTL_STEPS)], rtol=1e-5)
        assert res["ctl/n_workers"].tolist() == [DATA, DATA, DATA]
        assert bool(res["ctl/dtensor"])
        assert str(res["ctl/history"]) == str(ranks[0]["ctl/history"])


def test_controller_state_round_trips_on_the_model_axis(runs):
    """``restore_state`` into a fresh controller on the 2 × 2 mesh gives
    the schedule, history, telemetry and per-leaf k of the saved one,
    and its rebuilt step runs on the live DTensor state."""
    for res in runs[1]:
        assert bool(res["ctl/restored"])
        assert np.isfinite(res["ctl/restored_loss"])


def test_one_replan_decision_for_the_mesh(runs):
    """A trigger that fires on rank 1 only, beside per-rank wires: both
    ranks re-plan at step 2 from rank 0's (degraded) wire, log the same
    swap, and keep bitwise-equal parameters and losses."""
    ranks = runs[2]
    hist = [json.loads(str(r["history"])) for r in ranks]
    assert hist[0] == hist[1], hist
    assert [(e["step"], e["swapped"], e["trigger"]) for e in hist[0]] == [
        (2, True, "rank_one")]
    assert str(ranks[0]["schedule"]) == str(ranks[1]["schedule"]) != ""
    for k in ranks[0]:
        if k.startswith(("params", "loss")):
            np.testing.assert_array_equal(_bits(ranks[1][k]),
                                          _bits(ranks[0][k]), err_msg=k)


def test_publisher_cuts_the_one_card_packets(runs):
    """``Session.run(publisher=)`` on 2 × 2: a full packet then deltas,
    each bitwise the one-card publisher's of the gathered parameters;
    the published copy ``DTensor``s and the residual chunks; the
    published copy gathered bitwise the one card's; rank 0 alone writes
    the files; a ``ServeSession`` on 'model' applies them on every rank
    to the published parameters, bit for bit, and generates."""
    ranks = runs[1]
    for r, res in enumerate(ranks):
        assert res["pub/kinds"].tolist() == ["full"] + ["delta"] * (
            PUB_STEPS - 1)
        assert res["pub/rows"].tolist() == res["pub/kinds"].tolist()
        assert res["pub/same"].all(), res["pub/same"]
        assert bool(res["pub/residual_local"])
        assert bool(res["pub/published_dtensor"])
        assert bool(res["pub/published_is_one"])
        assert int(res["pub/files"]) == (PUB_STEPS if r == 0 else 0)
        assert res["serve/status"].tolist() == ["applied"] * PUB_STEPS
        assert bool(res["serve/same"])
        np.testing.assert_array_equal(res["serve/tokens"],
                                      ranks[0]["serve/tokens"])


def test_profile_model_on_the_model_axis(runs):
    """Two data workers, the mesh's (2, 2) shape, and per card counts:
    the bytes within ``BYTES_BAND`` of the reference's per-device
    ``cost_analysis()`` of its partitioned dense step, the FLOPs within
    ``FLOPS_BAND``; both packages' ``fit_hardware`` fit the same
    ``hbm_bw`` from the port's profile.  Both are per card: the
    reference's FLOPs fall 3.9-fold from data 1 × model 1 to 2 × 2 and
    the port's with them (the ratio 1.840 there, 1.837 here), where a
    count of the whole ops (the global shapes DTensor shows a dispatch
    mode) would double the ratio.  The ratio's 1.84 at every mesh is a
    difference between the two counters, not in the split.  The bytes
    sit above 1 for the reason ``test_torch_profiler.py`` gives (eager
    writes and reads back what XLA fuses), and higher at 2 × 2 (2.757
    against 2.195 at 1 × 1), where the activations replicated over
    'model' count whole on every rank and DTensor's 'model' collectives
    add their buffers."""
    from repro.autotune import costfit as JF
    from repro.autotune import profiler as JPR
    from repro_torch.autotune import costfit as TF
    from repro_torch.autotune import profiler as TPR
    jres = runs[0]
    for res in runs[1]:
        text = str(res["prof/json"])
        prof = TPR.ModelProfile.from_json(text)
        assert prof.n_workers == DATA
        assert tuple(prof.mesh_shape) == (DATA, MODEL)
        assert prof.t_step_dense > 0 and prof.t_step_lags > 0
        ratio = prof.hbm_bytes_per_step / float(jres["cost/bytes"])
        assert BYTES_BAND[0] <= ratio <= BYTES_BAND[1], ratio
        flops = prof.flops_per_step / float(jres["cost/flops"])
        assert FLOPS_BAND[0] <= flops <= FLOPS_BAND[1], flops
        hw = TF.fit_hardware(prof)
        assert hw.hbm_bw == prof.hbm_bytes_per_step / prof.t_step_dense
        assert JF.fit_hardware(JPR.ModelProfile.from_json(text)).hbm_bw \
            == hw.hbm_bw
