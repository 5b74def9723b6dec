"""Tensor parallelism, second part: ``slgs``, ``lags_hier2`` and
``lags_hier`` on ('data', 'model'), every mode on ('pod', 'data',
'model'), and ``lags_hier``'s FSDP over 'data', against the reference's
``build_train_step`` on the matching ``make_host_mesh`` meshes.

One module-scoped spawn of four gloo ranks builds data 2 × model 2 and
then pod 2 × data 1 × model 2; one of eight ranks builds pod 2 × data 2
× model 2; beside them, one JAX subprocess per mesh, all from the same
numpy weights and batches (the SMALL TinyLlama of ``test_torch_tp.py``,
f32).

Contracts:
  * every case of ``CASES`` matches the reference: losses rtol 1e-5;
    the gathered parameters, and each rank's chunk of the reference's
    per-worker residuals (per tier for ``lags_hier2``) and velocities,
    rtol 1e-4 atol 1e-5;
  * ``wave`` == ``off`` bit for bit for ``slgs``, ``lags_hier2`` and
    ``lags_hier`` at 2 × 2; the data replicas of each chunk bit for bit
    where the mode keeps them (every data rank of one model index, or
    under ``lags_hier`` every pod of one (data, model) coordinate);
  * under ``lags_hier`` each rank holds only its (data, model) block of
    each parameter and residual, the shapes of the reference's
    ``param_pspecs(cfg, mesh, "lags_hier")``; ``distribute``/``gather``
    round-trip on those blocks, and ``Session.run``'s checkpoint holds
    the full tensors;
  * the trap: a gather over 'data' inside autograd, whose backward takes
    each rank's chunk and sums nothing, leaves the residuals outside the
    tolerance, so the explicit reduce-scatter is seen to matter;
  * the gradients' placements on data 2 × model 2 before
    ``dtensor.grad_to_local``: their own or ``Partial`` over 'model'
    (the record behind its docstring);
  * on the pod mesh, the MoE token groups across ranks raise
    ``NotImplementedError`` naming ROADMAP.md queue 1 item 7, and the
    health quantities, a controller, ``profile_model`` and a publisher
    run (item 7g; ``test_torch_tp_observe.py`` holds them to the
    reference at 2 × 2).
"""
import dataclasses
import os
import textwrap

import numpy as np
import pytest
from test_torch_spawn import COMPILE_ONCE, Lazy, Spawned, load

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import transformer as JT  # noqa: E402

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 3, 8, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, compression_ratio=8.0, dtype="float32",
             param_dtype="float32")
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16, ratio_inner=4.0,
              inner_compressor="topk_block")
# mesh -> (pod, data, model)
MESHES = {"dm": (1, 2, 2), "pdm": (2, 1, 2), "pdm8": (2, 2, 2)}
# against the reference: case -> (mesh, mode, mc, steps, port backend)
CASES = {"dm/slgs": ("dm", "slgs", 0.0, 3, "xla"),
         "dm/lags_hier2": ("dm", "lags_hier2", 0.0, 3, "xla"),
         "dm/lags_hier": ("dm", "lags_hier", 0.0, 3, "kernel"),
         "dm/lags_hier_mc": ("dm", "lags_hier", 0.9, 3, "kernel"),
         "pdm/dense": ("pdm", "dense", 0.0, 3, "xla"),
         "pdm/lags_dp": ("pdm", "lags_dp", 0.0, 3, "kernel"),
         "pdm/lags_hier2": ("pdm", "lags_hier2", 0.0, 3, "xla"),
         "pdm/lags_hier": ("pdm", "lags_hier", 0.0, 3, "kernel"),
         "pdm8/lags_dp": ("pdm8", "lags_dp", 0.0, 2, "kernel"),
         "pdm8/lags_hier": ("pdm8", "lags_hier", 0.0, 2, "kernel")}
# wave == off at 2 x 2, bitwise
WAVE_PARITY = ("dm/slgs", "dm/lags_hier2", "dm/lags_hier")
WAVE_BYTES = 2048
N_LEAVES = 12
REFUSED = ("moe_family", "health", "controller", "profile_model",
           "publisher")

JAX_SCRIPT = """
import dataclasses, sys
import jax, numpy as np
from repro import api, compat
from repro.configs import base
from repro.launch import mesh as M, train as TR

which, inp, out_path = sys.argv[1], np.load(sys.argv[2]), sys.argv[3]
cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                          **SMALL)
pod, data, model = MESHES[which]
mesh = M.make_host_mesh(data=data, model=model, pod=pod)
is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
out = {}
for name, (on, mode, mc, steps, _) in CASES.items():
    if on != which:
        continue
    run = api.RunConfig(mode=mode, momentum_correction=mc, donate=False,
                        **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    step = compile_once(step)
    state, _ = TR.init_state(cfg, mesh, method=mode,
                             momentum_correction=mc)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(steps):
            batch = {"tokens": inp["tokens"][t], "labels": inp["labels"][t]}
            state, metrics = step(state, batch)
            out[f"{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef"):
        for i, x in enumerate(jax.tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = np.asarray(x)
    # per leaf, the dims its spec gives 'data' and 'model' (-1: none)
    specs = jax.tree.leaves(meta["pspecs"], is_leaf=is_spec)
    out[f"{name}/sdims"] = np.array([
        [next((i for i, e in enumerate(s) if e == a), -1)
         for a in ("data", "model")] for s in specs])
    out[f"{name}/n_workers"] = meta["n_workers"]
np.savez(out_path, **out)
print("OK jax", which)
"""

RANK_SCRIPT = """
import dataclasses, os, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from repro_torch import api, tree
from repro_torch.configs import tinyllama_1_1b
from repro_torch.launch import mesh as M, train as TR
from repro_torch.models import transformer as TT
from repro_torch.sharding import dtensor as D

world, rank, store, inp_path, out_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", world, rank, device="cpu")
cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **SMALL)
leaves, treedef = tree.flatten(TT.abstract_params(cfg))
start = tree.unflatten(treedef, [inp[f"param{i}"]
                                 for i in range(len(leaves))])
out = {}


def batch_at(t):
    return {"tokens": torch.from_numpy(inp["tokens"][t]),
            "labels": torch.from_numpy(inp["labels"][t])}


def make(which):
    pod, data, model = MESHES[which]
    mesh = M.make_mesh(data=data, model=model, pod=pod, device="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out[f"{which}/coord"] = np.array([coord.get("pod", 0), coord["data"],
                                      coord["model"]])
    axes = M.worker_axes(mesh, M.data_axis_names(mesh))
    out[f"{which}/workers"] = np.array(
        dist.get_process_group_ranks(axes.group))
    return mesh


def train(name, mesh, steps, **kw):
    run = api.RunConfig(wave_target_bytes=WAVE_BYTES, **RUN_KW, **kw)
    sess = api.Session(cfg, run, mesh=mesh)
    state, _ = sess.init_state(
        params=TT.from_jax_params(start, cfg, device="cpu").params)
    for t in range(steps):
        state, metrics = sess.step_fn(state, batch_at(t))
        out[f"{name}/loss{t}"] = float(metrics["loss"])
    for i, x in enumerate(tree.leaves(D.gather(state["params"]))):
        out[f"{name}/params{i}"] = x.numpy()
    for i, x in enumerate(tree.leaves(state["params"])):
        out[f"{name}/chunk{i}"] = D.local(x).detach().clone().numpy()
    for i, x in enumerate(tree.leaves(state["ef"])):
        out[f"{name}/ef{i}"] = x.clone().numpy()
    for i, x in enumerate(tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = x.clone().numpy()
    out[f"{name}/n_workers"] = sess.meta["n_workers"]
    return sess


class Trap(TR.DataShards):
    # the gather over 'data' inside autograd: the gradients are taken of
    # the 2-D parameters through DTensor's backward of the gather, and
    # nothing reduces them over 'data'
    def leaves(self, params):
        return [DTensor.from_local(
            p.redistribute(p.device_mesh, (Replicate(), p.placements[1]))
            .to_local(), self.model_mesh, pl, run_check=False)
            for p, pl in zip(params, self.placements)]

    def targets(self, params, leaves):
        return params

    def mean(self, i, u):
        return u


def record_placements(mesh):
    # the gradients' placements as the step sees them, before
    # grad_to_local, on one lags_dp step
    real, seen = D.grad_to_local, []

    def spy(g, p):
        seen.append(f"{tuple(p.placements)} <- {tuple(g.placements)}")
        return real(g, p)
    D.grad_to_local = spy
    try:
        train("placements/run", mesh, 1, mode="lags_dp",
              selection_backend="kernel")
    finally:
        D.grad_to_local = real
    out["placements"] = np.array(seen)


def refusals(mesh):
    # what stays refused of the MoE family: lags_hier's token groups
    # across ranks (4 rows on 2 pods x 2) beside a 'model' axis
    try:
        TR.pod_auto_moe_groups(4, 2, 2, model=2)
        out["refused/moe_family"] = np.array("no error")
    except NotImplementedError as err:
        out["refused/moe_family"] = np.array(str(err))
    # what it refused until item 7g runs: the health quantities under
    # lags_hier2, a lags_hier controller, profile_model and a publisher
    from repro_torch.autotune import profiler as PR
    from repro_torch.stream import StreamPublisher

    def start_of(sess):
        return sess.init_state(params=TT.from_jax_params(
            start, cfg, device="cpu").params)[0]
    sess = api.Session(cfg, api.RunConfig(mode="lags_hier2", health_every=1,
                                          **RUN_KW), mesh=mesh)
    _, metrics = sess.step_fn(start_of(sess), batch_at(0))
    out["7g/health"] = np.array([float(metrics["health_delta_max"]),
                                 len(metrics["health_delta"])])
    sess = api.Session(cfg, api.RunConfig(mode="lags_hier", **RUN_KW),
                       mesh=mesh)
    ctl = sess.controller(comm_probe=lambda m, a: [])
    ctl.step(start_of(sess), batch_at(0))
    ctl.maybe_replan(1, trigger="test")
    out["7g/controller"] = np.array([ctl.meta["n_workers"],
                                     *ctl.tier_workers, len(ctl.history)])
    prof = PR.profile_model(cfg, mesh, seq=S, global_batch=B, iters=1,
                            comm_sizes=(4096,))
    out["7g/profile_model"] = np.array([prof.n_workers, *prof.mesh_shape])
    sess = api.Session(cfg, api.RunConfig(mode="lags_dp", **RUN_KW),
                       mesh=mesh)
    state = start_of(sess)
    _, hist = sess.run(batch_at, 1, state=state, print_fn=lambda *a: None,
                       publisher=StreamPublisher(state["params"], every=1))
    out["7g/publisher"] = np.array([hist[0]["publish"]["kind"] == "full"])


for which in WHICH:
    mesh = make(which)
    for name, (on, mode, mc, steps, backend) in CASES.items():
        if on == which:
            train(name, mesh, steps, mode=mode, momentum_correction=mc,
                  selection_backend=backend)
    for name in WAVE_PARITY:
        on, mode, _, steps, backend = CASES[name]
        if on == which:
            train(name + "/wave", mesh, steps, mode=mode, pipeline="wave",
                  selection_backend=backend)
    # lags_hier's FSDP blocks: distribute / gather round trip
    specs = api.Session(cfg, api.RunConfig(mode="lags_hier"),
                        mesh=mesh).meta["pspecs"]
    module = TT.from_jax_params(start, cfg, device="cpu")
    blocks = D.distribute(module.params, specs, mesh, D.PARAM_AXES_FSDP)
    out[f"{which}/roundtrip"] = np.array(all(
        torch.equal(a.detach(), b) for a, b in zip(
            tree.leaves(module.params), tree.leaves(D.gather(blocks)))))
    if which == "dm":
        real = TR.DataShards
        TR.DataShards = Trap
        try:
            train("dm/lags_hier/trap", mesh, STEPS, mode="lags_hier",
                  selection_backend="kernel")
        finally:
            TR.DataShards = real
        record_placements(mesh)
        # Session.run's checkpoint: the full tensors, gathered over the
        # pod's (data, model) ranks
        from repro_torch.checkpoint import io as ckpt
        sess = api.Session(cfg, api.RunConfig(mode="lags_hier", **RUN_KW),
                           mesh=mesh)
        state, _ = sess.init_state(
            params=TT.from_jax_params(start, cfg, device="cpu").params)
        ck_dir = os.path.join(os.path.dirname(out_path), f"ckpt{rank}")
        state, _ = sess.run(batch_at, 1, state=state, out_dir=ck_dir,
                            print_fn=lambda *a: None)
        full = D.gather(state["params"])
        saved = ckpt.restore(os.path.join(ck_dir, "ckpt_final"), {
            "params": full, "step": np.asarray(0, np.int32)})
        out["dm/ckpt_full"] = np.array(int(saved["step"]) == 1 and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(saved["params"]),
                                              tree.leaves(full))))
    if which == "pdm":
        refusals(mesh)
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants(**extra) -> str:
    names = ("STEPS", "SMALL", "RUN_KW", "MESHES", "CASES", "WAVE_PARITY",
             "WAVE_BYTES", "REFUSED", "B", "S")
    return "".join(f"{n} = {globals()[n]!r}\n" for n in names) + "".join(
        f"{n} = {v!r}\n" for n, v in extra.items())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three JAX subprocesses (one a mesh), four gloo ranks (data 2 ×
    model 2, then pod 2 × data 1 × model 2) and eight (pod 2 × data 2 ×
    model 2), started together (``test_torch_spawn.Spawned``); results by
    index, each read when a test first needs it: (JAX results by mesh,
    the four ranks' results, the eight ranks')."""
    from repro.configs import base
    tmp = tmp_path_factory.mktemp("tp_modes")
    cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                              **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, SMALL["vocab"], (STEPS, B, S + 1)).astype(
        np.int32)
    inp = {f"param{i}": np.asarray(p)
           for i, p in enumerate(jax.tree.leaves(params))}
    inp.update(tokens=toks[..., :-1], labels=toks[..., 1:])
    np.savez(tmp / "in.npz", **inp)

    sp = Spawned(tmp, dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                           JAX_PLATFORMS="cpu"))
    # the reference's CPU code at LLVM's lowest optimization level, each
    # step compiled once, on one thread (``test_torch_spawn``)
    code = COMPILE_ONCE + _constants() + textwrap.dedent(JAX_SCRIPT)
    for which, shape in MESHES.items():
        sp.start(f"jax_{which}", code,
                 [which, tmp / "in.npz", tmp / f"jax_{which}.npz"],
                 XLA_FLAGS="--xla_backend_optimization_level=0 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "--xla_force_host_platform_device_count="
                           f"{int(np.prod(shape))}")
    spawns = {4: ("dm", "pdm"), 8: ("pdm8",)}
    for world, which in spawns.items():
        code = _constants(WHICH=which) + textwrap.dedent(RANK_SCRIPT)
        for r in range(world):
            sp.start(f"rank{world}_{r}", code,
                     [world, r, tmp / f"store{world}", tmp / "in.npz",
                      tmp / f"rank{world}_{r}.npz"], OMP_NUM_THREADS="1")

    def jax_results(which):
        sp.wait(f"jax_{which}")
        return load(tmp / f"jax_{which}.npz")

    def rank_results(world):
        names = [f"rank{world}_{r}" for r in range(world)]
        sp.wait(*names)
        return [load(tmp / f"{n}.npz") for n in names]
    try:
        yield Lazy(lambda: ByMesh(jax_results), lambda: rank_results(4),
                   lambda: rank_results(8))
    finally:
        sp.close()


class ByMesh(dict):
    """The JAX results by mesh, each read (its subprocess waited on)
    when first asked for."""

    def __init__(self, read):
        super().__init__()
        self.read = read

    def __missing__(self, which):
        self[which] = self.read(which)
        return self[which]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _ranks(runs, which: str) -> list:
    return runs[2] if which == "pdm8" else runs[1]


def _block(x: np.ndarray, dims, coord, sizes) -> np.ndarray:
    """The block of ``x`` at ``coord`` (data, model) over ``sizes``:
    ``dims`` the (data, model) dims (-1: not split)."""
    for d, c, n in zip(dims, coord, sizes):
        if d >= 0:
            x = np.split(x, n, axis=d)[c]
    return x


def _worker_block(case: str, res: dict, sdims, i: int, x: np.ndarray):
    """This rank's chunk of the reference's per-worker state leaf ``x``
    ((n_workers, *full)): its worker's row, then its block."""
    which, mode = CASES[case][0], CASES[case][1]
    pod, data, model = MESHES[which]
    p, d, m = res[f"{which}/coord"]
    if mode == "lags_hier":          # one worker per pod, FSDP blocks
        return _block(x[p], sdims[i], (d, m), (data, model))
    return _block(x[p * data + d], (-1, sdims[i][1]), (d, m), (data, model))


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax_build_train_step(runs, case):
    """Each case against the reference's ``build_train_step`` on its
    ``make_host_mesh``: losses rtol 1e-5, the same on every rank; the
    gathered parameters rtol 1e-4 atol 1e-5, the same on every rank;
    each rank's residual (each tier) and velocity chunk against its
    block of the reference's per-worker state, rtol 1e-4 atol 1e-5."""
    which, mode, mc, steps, _ = CASES[case]
    jres, ranks = runs[0][which], _ranks(runs, which)
    sdims = jres[f"{case}/sdims"]
    got = ranks[0]
    assert got[f"{case}/n_workers"] == jres[f"{case}/n_workers"]
    np.testing.assert_allclose(
        [got[f"{case}/loss{t}"] for t in range(steps)],
        [jres[f"{case}/loss{t}"] for t in range(steps)], rtol=1e-5)
    for i in range(N_LEAVES):
        key = f"{case}/params{i}"
        np.testing.assert_allclose(got[key], jres[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    for res in ranks:
        for t in range(steps):
            assert res[f"{case}/loss{t}"] == got[f"{case}/loss{t}"]
        for i in range(N_LEAVES):
            np.testing.assert_array_equal(res[f"{case}/params{i}"],
                                          got[f"{case}/params{i}"])
    n_tiers = 2 if mode == "lags_hier2" else 1
    for part, want in (("ef", 0 if mode == "dense" else N_LEAVES * n_tiers),
                       ("mom", N_LEAVES if mc else 0)):
        keys = [k for k in jres if k.startswith(f"{case}/{part}")]
        assert len(keys) == want, (part, keys)
        for key in keys:
            i = int(key[len(f"{case}/{part}"):]) % N_LEAVES
            for r, res in enumerate(ranks):
                np.testing.assert_allclose(
                    res[key][0], _worker_block(case, res, sdims, i, jres[key]),
                    rtol=1e-4, atol=1e-5, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("case", WAVE_PARITY)
def test_wave_equals_off_bitwise(runs, case):
    """``wave`` (the whole-leaf exchange launched from the hooks for
    ``slgs`` and ``lags_hier2``; after the reduce-scatter for
    ``lags_hier``) == ``off``, bit for bit: losses, parameter chunks and
    residuals on every rank."""
    steps = CASES[case][3]
    for res in runs[1]:
        keys = [k[len(case) + 1:] for k in res if k.startswith(case + "/")
                and not k.startswith(case + "/wave")
                and not k.startswith(case + "/trap")]
        assert len(keys) >= steps + 2 * N_LEAVES
        for k in keys:
            np.testing.assert_array_equal(
                _bits(res[f"{case}/wave/{k}"]), _bits(res[f"{case}/{k}"]),
                err_msg=k)


# the ranks that hold one chunk's replicas: case -> their coordinate's
# axes ("pod", "data") over which the chunk must be equal
REPLICAS = {"dm/slgs": "data", "dm/lags_hier2": "data",
            "pdm/dense": "pod", "pdm/lags_dp": "pod",
            "pdm/lags_hier2": "pod", "pdm/lags_hier": "pod",
            "pdm8/lags_dp": "pod data", "pdm8/lags_hier": "pod"}


@pytest.mark.parametrize("case", list(REPLICAS))
def test_replicas_of_each_chunk_are_bitwise_equal(runs, case):
    """The ranks that differ only on the replica axes hold the same
    parameter chunks, bit for bit: the data replicas of ``slgs`` and
    ``lags_hier2``, every pod's copy (and data replica) of the flat
    modes, and under ``lags_hier`` each pod's block after its cross-pod
    exchange."""
    which = CASES[case][0]
    ranks = _ranks(runs, which)
    keep = [a not in REPLICAS[case] for a in ("pod", "data")] + [True]
    groups: dict = {}
    for res in ranks:
        c = tuple(int(v) for v, k in zip(res[f"{which}/coord"], keep) if k)
        groups.setdefault(c, []).append(res)
    assert all(len(g) > 1 for g in groups.values()), groups.keys()
    for group in groups.values():
        for res in group[1:]:
            for i in range(N_LEAVES):
                np.testing.assert_array_equal(
                    _bits(res[f"{case}/chunk{i}"]),
                    _bits(group[0][f"{case}/chunk{i}"]), err_msg=str(i))


@pytest.mark.parametrize("case", ["dm/lags_hier", "pdm/lags_hier",
                                  "pdm8/lags_hier"])
def test_lags_hier_holds_only_its_data_model_blocks(runs, case):
    """Under ``lags_hier`` every rank's parameter and residual leaves are
    its (data, model) block: the full shape split on the dims the
    reference's ``param_pspecs(cfg, mesh, "lags_hier")`` gives 'data' and
    'model', the block at the rank's coordinate."""
    which = CASES[case][0]
    jres, ranks = runs[0][which], _ranks(runs, which)
    _, data, model = MESHES[which]
    sdims = jres[f"{case}/sdims"]
    if data > 1:
        assert (sdims[:, 0] >= 0).sum() >= 9, sdims
    for res in ranks:
        d, m = res[f"{which}/coord"][1:]
        for i in range(N_LEAVES):
            full = res[f"{case}/params{i}"]
            want = _block(full, sdims[i], (d, m), (data, model))
            np.testing.assert_array_equal(res[f"{case}/chunk{i}"], want)
            assert res[f"{case}/ef{i}"].shape == (1,) + want.shape


@pytest.mark.parametrize("which", list(MESHES))
def test_distribute_gather_round_trip_on_data_model_blocks(runs, which):
    """``gather(distribute(params, specs, mesh, PARAM_AXES_FSDP))`` is the
    tree itself, bit for bit, on every mesh."""
    for res in _ranks(runs, which):
        assert bool(res[f"{which}/roundtrip"])


def test_lags_hier_checkpoint_holds_the_full_tensors(runs):
    """``Session.run``'s checkpoint under ``lags_hier`` on data 2 × model
    2 holds the full tensors (gathered over the pod's (data, model)
    ranks) in the reference's format."""
    for res in runs[1]:
        assert bool(res["dm/ckpt_full"])


@pytest.mark.parametrize("which", list(MESHES))
def test_worker_group_is_the_model_index_over_the_data_axes(runs, which):
    """``worker_axes(mesh, data_axis_names(mesh))`` is the group of the
    ranks that share this rank's model index, pod-major."""
    pod, data, model = MESHES[which]
    for r, res in enumerate(_ranks(runs, which)):
        m = r % model
        np.testing.assert_array_equal(
            res[f"{which}/workers"], np.arange(pod * data) * model + m)


def test_the_data_axis_gather_inside_autograd_leaves_the_tolerance(runs):
    """The trap planted (``Trap`` in the rank script: each leaf gathered
    over 'data' by a DTensor redistribute inside autograd, the gradient
    taken of the 2-D parameter, nothing reduced over 'data'): each data
    rank keeps its own rows' share of the gradient, and the residuals
    leave the tolerance the sound path meets."""
    jres = runs[0]["dm"]
    sdims = jres["dm/lags_hier/sdims"]
    worst = 0.0
    for res in runs[1]:
        for i in range(N_LEAVES):
            want = _worker_block("dm/lags_hier", res, sdims, i,
                                 jres[f"dm/lags_hier/ef{i}"])
            got = res[f"dm/lags_hier/trap/ef{i}"][0]
            excess = np.abs(got - want) - (1e-5 + 1e-4 * np.abs(want))
            worst = max(worst, float(excess.max()))
    assert worst > 0.0, "the planted trap stayed inside the tolerance"
    assert not np.allclose(runs[1][0]["dm/lags_hier/trap/params0"],
                           jres["dm/lags_hier/params0"], rtol=1e-4, atol=1e-5)


def test_gradient_placements_before_grad_to_local(runs):
    """The record behind ``dtensor.grad_to_local``'s docstring, on this
    torch: each gradient of one ``lags_dp`` step on data 2 × model 2,
    beside its parameter's placements.  Each comes back in its
    parameter's own placements or ``Partial(sum)`` over 'model' (on
    torch 2.13: 9 of the 12, the three norms among them); a replicated
    parameter's ``Partial`` gradient has the parameter's local shape, so
    a skipped reduction would run silently on partial sums."""
    seen = [str(s) for s in runs[1][0]["placements"]]
    assert len(seen) == N_LEAVES
    partial = 0
    for entry in seen:
        param, grad = entry.split(" <- ")
        assert grad in (param, "(Partial(sum),)"), entry
        partial += grad != param
    assert partial > N_LEAVES // 2, seen
    assert "(Replicate(),) <- (Partial(sum),)" in seen, seen
    for res in runs[1][1:]:
        assert [str(s) for s in res["placements"]] == seen


@pytest.mark.parametrize("case", REFUSED)
def test_what_the_slice_does_not_cover_raises_naming_item_7(runs, case):
    """On pod 2 × data 1 × model 2: the MoE token groups across ranks
    raise ``NotImplementedError`` naming their part of ROADMAP.md queue 1
    item 7.  What raised there until item 7g runs, alike on every rank:
    one ``lags_hier2`` step with the health quantities (δ of every leaf,
    its max above 0), a ``lags_hier`` controller (2 workers, one a pod;
    tier workers 1 inside a pod, 2 across; a re-plan logged),
    ``profile_model`` (2 data workers over ('pod', 'data'), the mesh's
    shape) and ``Session.run`` with a publisher (a full packet)."""
    if case == "moe_family":
        for res in runs[1]:
            msg = str(res[f"refused/{case}"])
            assert "item 7" in msg, msg
        return
    got = runs[1][0][f"7g/{case}"]
    for res in runs[1][1:]:
        np.testing.assert_array_equal(res[f"7g/{case}"], got)
    if case == "health":
        assert got[0] > 0.0 and got[1] == N_LEAVES, got
    else:
        assert got.tolist() == {"controller": [2, 1, 2, 1],
                                "profile_model": [2, 2, 1, 2],
                                "publisher": [True]}[case], got
