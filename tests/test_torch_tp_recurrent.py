"""Tensor parallelism for the recurrent families: the mLSTM, sLSTM and
Mamba layers on 'model', xLSTM, the paper's LSTM and the Jamba hybrid
on ("data", "model") and ("pod", "data", "model"), against the
reference.

One module-scoped start of every process: two gloo ranks at model 2 for
the layers alone (their reference runs unsharded in this process:
GSPMD only partitions that math); four gloo ranks (data 2 × model 2,
then pod 2 × data 1 × model 2) beside one JAX subprocess for every
train-step case; a gloo world of one for the 1 × 1 mesh.  The same
numpy weights and batches on both sides: each model's smoke config in
f32, 32 tokens a sequence.

Contracts:
  * the layers alone, leaves laid out by the reference's rules at model
    2 (``rules.tree_specs``): the port's ``mlstm_forward``,
    ``slstm_forward`` and ``mamba_forward`` output and the gradients of
    ``sum(out·w)`` with respect to x and every leaf equal the
    reference's unsharded layer under ``jax.grad``, rtol and atol 1e-5;
    one planted fault a layer leaves that tolerance (Mamba: ``x_proj``'s
    partial sum left unreduced; mLSTM: ``out_norm``'s mean square over
    the local channels only; sLSTM: z taken from this rank's own
    ``up_proj`` columns);
  * the train step: 2 steps of every case of ``CASES`` match the
    reference's ``build_train_step``: losses rtol 1e-5 and the same on
    every rank; the gathered parameters rtol 1e-4 atol 1e-5 and the same
    on every rank; each rank's residual chunk against its block of the
    reference's per-worker residual, rtol 1e-4 atol 1e-5; the data
    replicas of each chunk bit for bit where the mode keeps them, and
    ``wave`` == ``off`` bit for bit on xLSTM's ``lags_dp``;
  * on ("data", "model") = 1 × 1 (a world of one), 3 bf16 ``lags_dp``
    steps of xLSTM and Jamba are bitwise the data-only mesh's;
  * ``check_tensor_parallel`` admits the ``ssm`` and ``hybrid``
    families under every mode (pure Python).
"""
import dataclasses
import os
import textwrap

import numpy as np
import pytest
from test_torch_spawn import COMPILE_ONCE, Lazy, Spawned, load

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 2, 8, 32
F32 = dict(dtype="float32", param_dtype="float32")
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16, ratio_inner=4.0,
              inner_compressor="topk_block")
# the layers alone: (batch, tokens) of x, and each layer's smoke arch
LAYER_X = (2, 32)
LAYERS = {"mlstm": "xlstm_1_3b", "slstm": "xlstm_1_3b",
          "mamba": "jamba_v0_1_52b"}
# the planted fault of each layer
LAYER_FAULTS = {"mlstm": "norm_local", "slstm": "z_own_columns",
                "mamba": "xproj_unreduced"}
# mesh -> (pod, data, model)
MESHES = {"dm": (1, 2, 2), "pdm": (2, 1, 2)}
# case -> (mesh, arch, mode, port backend)
CASES = {
    "dm/xlstm/lags_dp": ("dm", "xlstm_1_3b", "lags_dp", "kernel"),
    "dm/xlstm/dense": ("dm", "xlstm_1_3b", "dense", "xla"),
    "dm/lstm/lags_dp": ("dm", "paper_lstm_ptb", "lags_dp", "kernel"),
    "dm/jamba/lags_dp": ("dm", "jamba_v0_1_52b", "lags_dp", "kernel"),
    "dm/jamba/lags_hier": ("dm", "jamba_v0_1_52b", "lags_hier", "kernel"),
    "pdm/xlstm/lags_hier2": ("pdm", "xlstm_1_3b", "lags_hier2", "xla"),
}
ARCHS = sorted({c[1] for c in CASES.values()})
# wave == off, bit for bit
WAVE_PARITY = ("dm/xlstm/lags_dp",)
WAVE_BYTES = 2048
# the train step's JAX subprocesses, started together: each Jamba case
# alone (most of the compile time), the rest in one
JAX_SPLIT = (("dm/xlstm/lags_dp", "dm/xlstm/dense", "dm/lstm/lags_dp",
              "pdm/xlstm/lags_hier2"), ("dm/jamba/lags_dp",),
             ("dm/jamba/lags_hier",))
# the ranks that hold one chunk's replicas: case -> the axis over which
# the chunk must be equal
REPLICAS = {"dm/xlstm/lags_dp": "data", "dm/xlstm/dense": "data",
            "dm/lstm/lags_dp": "data", "dm/jamba/lags_dp": "data",
            "pdm/xlstm/lags_hier2": "pod"}
# the world of one: the archs held bitwise on 1 x 1
ONE_ARCHS = ("xlstm_1_3b", "jamba_v0_1_52b")

LAYER_RANK = """
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import base
from repro_torch.launch import mesh as M
from repro_torch.models import ssm as TS, tp as TP, xlstm as TX
from repro_torch.sharding import dtensor as D, rules

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", 2, rank, device="cpu")
mesh = M.make_mesh(model=2, device="cpu")
sub = D.sub_mesh(mesh)
out = {}
real = {"split_pair": TP.split_pair, "all_sum": TP.all_sum,
        "model_mean": TP.model_mean}
faults = {
    "norm_local": ("model_mean", lambda x, mesh: x),
    "z_own_columns": ("split_pair", lambda x, mesh: (
        real["split_pair"](x, mesh)[0], torch.chunk(x, 2, dim=-1)[1])),
    "xproj_unreduced": ("all_sum", lambda x, mesh: x)}


def full(t):
    return t.full_tensor().detach().numpy() if isinstance(t, DTensor) \\
        else t.detach().numpy()


def run(kind, cfg, p, key):
    x = DTensor.from_local(torch.from_numpy(inp[kind + "/x"]).clone(), sub,
                           (Replicate(),)).requires_grad_()
    w = torch.from_numpy(inp[kind + "/w"])
    fwd = {"mlstm": lambda: TX.mlstm_forward(p, x, n_heads=cfg.n_heads,
                                             chunk=16),
           "slstm": lambda: TX.slstm_forward(p, x, n_heads=cfg.n_heads),
           "mamba": lambda: TS.mamba_forward(p, x)}[kind]
    names = sorted(p)
    with implicit_replication():
        o = fwd()
        grads = torch.autograd.grad((o * w).sum(), [x] + [p[k] for k in names])
    out[key + "/out"] = full(o)
    out[key + "/grad_x"] = full(grads[0])
    for k, g in zip(names, grads[1:]):
        out[f"{key}/grad_{k}"] = full(g)


for kind, arch in LAYERS.items():
    cfg = base.get_smoke_config(arch)
    leaves = {k[len(kind) + 3:]: torch.from_numpy(v) for k, v in inp.items()
              if k.startswith(kind + "/p/")}
    axes = {"mlstm": lambda: TX.mlstm_specs(cfg.d_model, cfg.n_heads),
            "slstm": lambda: TX.slstm_specs(cfg.d_model, cfg.n_heads),
            "mamba": lambda: TS.mamba_specs(cfg.d_model)}[kind]()[1]
    specs = rules.tree_specs(leaves, axes, rules.mesh_axis_sizes(mesh))
    p = D.distribute(leaves, specs, mesh)
    out[kind + "/placements"] = np.array(sorted(
        f"{k} {tuple(v.placements)}" for k, v in p.items()))
    run(kind, cfg, p, kind)
    which, fn = faults[LAYER_FAULTS[kind]]
    setattr(TP, which, fn)
    try:
        run(kind, cfg, p, f"{kind}/fault")
    finally:
        setattr(TP, which, real[which])
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK layer rank", rank)
"""

STEP_JAX = """
import dataclasses, sys
import jax, numpy as np
from repro import api, compat
from repro.configs import base
from repro.launch import mesh as M, train as TR

names, inp, out_path = (sys.argv[1].split(","), np.load(sys.argv[2]),
                        sys.argv[3])
is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
out = {}
for name in names:
    which, arch, mode, _ = CASES[name]
    cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
    pod, data, model = MESHES[which]
    mesh = M.make_host_mesh(data=data, model=model, pod=pod)
    run = api.RunConfig(mode=mode, donate=False, **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    step = compile_once(step)
    state, _ = TR.init_state(cfg, mesh, method=mode)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"{arch}/param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            batch = {k: inp[f"{arch}/{k}"][t] for k in ("tokens", "labels")}
            state, metrics = step(state, batch)
            out[f"{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef"):
        for i, x in enumerate(jax.tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = np.asarray(x)
    specs = jax.tree.leaves(meta["pspecs"], is_leaf=is_spec)
    out[f"{name}/sdims"] = np.array([
        [next((i for i, e in enumerate(s) if e == a), -1)
         for a in ("data", "model")] for s in specs])
    out[f"{name}/n_workers"] = meta["n_workers"]
np.savez(out_path, **out)
print("OK jax")
"""

STEP_RANK = """
import dataclasses, sys
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
M.init_process_group(f"file://{store}", 4, rank, device="cpu")
out = {}


def train(name, mesh, arch, steps, **kw):
    cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
    leaves, treedef = tree.flatten(TT.abstract_params(cfg))
    start = tree.unflatten(treedef, [inp[f"{arch}/param{i}"]
                                     for i in range(len(leaves))])
    sess = api.Session(cfg, api.RunConfig(wave_target_bytes=WAVE_BYTES,
                                          **RUN_KW, **kw), mesh=mesh)
    state, _ = sess.init_state(
        params=TT.from_jax_params(start, cfg, device="cpu").params)
    for t in range(steps):
        batch = {k: torch.from_numpy(inp[f"{arch}/{k}"][t])
                 for k in ("tokens", "labels")}
        state, metrics = sess.step_fn(state, batch)
        out[f"{name}/loss{t}"] = float(metrics["loss"])
    for i, x in enumerate(tree.leaves(D.gather(state["params"]))):
        out[f"{name}/params{i}"] = x.numpy()
    for i, x in enumerate(tree.leaves(state["params"])):
        out[f"{name}/chunk{i}"] = D.local(x).detach().clone().numpy()
    for i, x in enumerate(tree.leaves(state["ef"])):
        out[f"{name}/ef{i}"] = x.clone().numpy()
    out[f"{name}/n_workers"] = sess.meta["n_workers"]


for which, (pod, data, model) in MESHES.items():
    mesh = M.make_mesh(data=data, model=model, pod=pod, device="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out[f"{which}/coord"] = np.array([coord.get("pod", 0), coord["data"],
                                      coord["model"]])
    for name, (on, arch, mode, backend) in CASES.items():
        if on == which:
            train(name, mesh, arch, STEPS, mode=mode,
                  selection_backend=backend)
    for name in WAVE_PARITY:
        on, arch, mode, backend = CASES[name]
        if on == which:
            train(name + "/wave", mesh, arch, STEPS, mode=mode,
                  selection_backend=backend, pipeline="wave")
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""

ONE_RANK = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import api, tree
from repro_torch.configs import base
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT
from repro_torch.sharding import dtensor as D

store, out_path = sys.argv[1], sys.argv[2]
M.init_process_group(f"file://{store}", 1, 0, device="cpu")
out = {}
for arch in ONE_ARCHS:
    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="bfloat16",
                              param_dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for name, mesh in (("data", M.make_mesh(device="cpu")),
                       ("1x1", M.make_mesh(model=1, device="cpu"))):
        for pipeline in ("off", "wave"):
            sess = api.Session(cfg, api.RunConfig(
                mode="lags_dp", selection_backend="kernel",
                pipeline=pipeline, wave_target_bytes=WAVE_BYTES, **RUN_KW),
                mesh=mesh)
            state, _ = sess.init_state(
                params=TT.Transformer(cfg, seed=0, device="cpu").params)
            key = f"{arch}/{name}/{pipeline}"
            out[key + "/dtensor"] = np.array(all(
                D.is_dtensor(p) for p in tree.leaves(state["params"])))
            for t in range(3):
                state, metrics = sess.step_fn(state, batch)
                out[f"{key}/loss{t}"] = float(metrics["loss"])
            for i, x in enumerate(tree.leaves(state["params"])
                                  + tree.leaves(state["ef"])):
                out[f"{key}/leaf{i}"] = D.local(x).detach().float().numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK one rank")
"""


def _constants() -> str:
    names = ("S", "STEPS", "F32", "RUN_KW", "LAYERS", "LAYER_FAULTS",
             "MESHES", "CASES", "WAVE_PARITY", "WAVE_BYTES", "ONE_ARCHS")
    return "".join(f"{n} = {globals()[n]!r}\n" for n in names)


def _layer_leaves(kind: str, cfg) -> dict:
    """The reference's init of one layer's leaves (f32), as numpy."""
    from repro.models import ssm as JS
    from repro.models import xlstm as JX
    key = jax.random.PRNGKey(1)
    if kind == "mlstm":
        p, _ = JX.init_mlstm(key, cfg.d_model, cfg.n_heads, np.float32)
    elif kind == "slstm":
        p, _ = JX.init_slstm(key, cfg.d_model, cfg.n_heads, np.float32)
    else:
        p, _ = JS.init_mamba(key, cfg.d_model, np.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _inputs() -> dict:
    """The weights and batches of every model, and each layer's leaves,
    tokens and cotangent, from seeds (numpy, and the reference's
    inits)."""
    from repro.configs import base
    from repro.models import transformer as JT
    # the seed of test_torch_tp_families.py.  Seed 28 put exact |acc| ties
    # at a block's k-th pick (Jamba's MoE w_down, xLSTM's up_proj under
    # lags_hier2), where the packages' last-bit differences pick apart
    rng = np.random.default_rng(27)
    inp = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
        params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        for i, p in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param{i}"] = np.asarray(p)
        toks = rng.integers(0, cfg.vocab, (STEPS, B, S + 1)).astype(np.int32)
        inp[f"{arch}/tokens"], inp[f"{arch}/labels"] = (toks[..., :-1],
                                                        toks[..., 1:])
    for kind, arch in LAYERS.items():
        cfg = base.get_smoke_config(arch)
        for k, v in _layer_leaves(kind, cfg).items():
            inp[f"{kind}/p/{k}"] = v
        shape = LAYER_X + (cfg.d_model,)
        inp[f"{kind}/x"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"{kind}/w"] = rng.standard_normal(shape).astype(np.float32)
    return inp


def _layer_reference(inp: dict) -> dict:
    """Each layer's output and the gradients of ``sum(out·w)`` with
    respect to x and every leaf, the reference's unsharded layer under
    ``jax.grad``."""
    from repro.configs import base
    from repro.models import ssm as JS
    from repro.models import xlstm as JX
    out = {}
    for kind, arch in LAYERS.items():
        cfg = base.get_smoke_config(arch)
        p = {k[len(kind) + 3:]: jax.numpy.asarray(v) for k, v in inp.items()
             if k.startswith(kind + "/p/")}
        fwd = {"mlstm": lambda p, x: JX.mlstm_forward(p, x,
                                                      n_heads=cfg.n_heads),
               "slstm": lambda p, x: JX.slstm_forward(p, x,
                                                      n_heads=cfg.n_heads),
               "mamba": JS.mamba_forward}[kind]
        w = jax.numpy.asarray(inp[kind + "/w"])

        def f(p, x):
            o = fwd(p, x)
            return (o * w).sum(), o
        (_, o), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, jax.numpy.asarray(
                inp[kind + "/x"]))
        out[kind + "/out"], out[kind + "/grad_x"] = np.asarray(o), \
            np.asarray(gx)
        for k, v in gp.items():
            out[f"{kind}/grad_{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process, started together: the layers' two gloo ranks, the
    train step's JAX subprocess and its four gloo ranks, and the world of
    one (``test_torch_spawn.Spawned``: each waited on, within its
    deadline, by the tests that read it); the train step's JAX work in
    ``JAX_SPLIT``'s subprocesses.  Results by index, each
    computed when first read: (the layers' reference results, here; the
    layers' ranks' results, step JAX results, the step's ranks' results,
    the world of one's)."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    head = _constants()
    sp = Spawned(tmp, dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                           JAX_PLATFORMS="cpu"))
    # the reference's CPU code at LLVM's lowest optimization level (a
    # third less compile time, the same results within the tolerances),
    # each step compiled once, on one thread
    assert sorted(sum(JAX_SPLIT, ())) == sorted(CASES)
    for i, names in enumerate(JAX_SPLIT):
        sp.start(f"jax_step{i}", COMPILE_ONCE + head + textwrap.dedent(
            STEP_JAX), [",".join(names), tmp / "in.npz",
                        tmp / f"jax_step{i}.npz"],
                 XLA_FLAGS="--xla_backend_optimization_level=0 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "--xla_force_host_platform_device_count=4")
    for r in range(4):
        sp.start(f"step_rank{r}", head + textwrap.dedent(STEP_RANK),
                 [r, tmp / "store4", tmp / "in.npz", tmp / f"step{r}.npz"],
                 OMP_NUM_THREADS="1")
    for r in range(2):
        sp.start(f"layer_rank{r}", head + textwrap.dedent(LAYER_RANK),
                 [r, tmp / "store2", tmp / "in.npz", tmp / f"layer{r}.npz"],
                 OMP_NUM_THREADS="1")
    sp.start("one_rank", head + textwrap.dedent(ONE_RANK),
             [tmp / "store1", tmp / "one.npz"], OMP_NUM_THREADS="1")

    def ranks(name, n, out):
        sp.wait(*(f"{name}{r}" for r in range(n)))
        return [load(tmp / f"{out}{r}.npz") for r in range(n)]

    def one(name, out):
        sp.wait(name)
        return load(tmp / out)

    def step_jax():
        res = {}
        for i in range(len(JAX_SPLIT)):
            res.update(one(f"jax_step{i}", f"jax_step{i}.npz"))
        return res
    try:
        yield Lazy(lambda: _layer_reference(inp),
                   lambda: ranks("layer_rank", 2, "layer"), step_jax,
                   lambda: ranks("step_rank", 4, "step"),
                   lambda: one("one_rank", "one.npz"))
    finally:
        sp.close()


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.slow
@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_output_and_gradients_match_the_reference(runs, kind):
    """Each layer at model 2 on leaves laid out by the reference's rules
    (the mLSTM on "inner", the sLSTM on "heads" and "ffn", Mamba on
    "inner"): its output and the gradients of ``sum(out·w)`` with
    respect to x and every leaf equal the reference's unsharded layer
    under ``jax.grad``, rtol and atol 1e-5, on both ranks."""
    ref, ranks = runs[0], runs[1]
    names = sorted(k[len(kind) + 1:] for k in ref if k.startswith(kind + "/"))
    n_leaves = len([k for k in names if k.startswith("grad_")]) - 1
    assert {"out", "grad_x"} <= set(names) and n_leaves >= 6, names
    for r, res in enumerate(ranks):
        placed = [str(s) for s in res[kind + "/placements"]]
        assert len(placed) == n_leaves
        assert sum("Shard" in s for s in placed) >= 4, placed
        for k in names:
            np.testing.assert_allclose(res[f"{kind}/{k}"], ref[f"{kind}/{k}"],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{kind}/{k} rank {r}")


@pytest.mark.slow
@pytest.mark.parametrize("kind", list(LAYERS))
def test_a_planted_fault_leaves_the_tolerance(runs, kind):
    """Mamba's ``x_proj`` partial sum left unreduced, the mLSTM's
    ``out_norm`` mean square over the local channels only, or the
    sLSTM's z taken from this rank's own ``up_proj`` columns: the
    output leaves the tolerance the sound layer meets."""
    ref, ranks = runs[0], runs[1]
    for res in ranks:
        assert not np.allclose(res[f"{kind}/fault/out"], ref[f"{kind}/out"],
                               rtol=1e-5, atol=1e-5), \
            f"{LAYER_FAULTS[kind]} stayed inside the tolerance"


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
    which, _, mode, _ = CASES[case]
    _, data, model = MESHES[which]
    p, d, m = res[f"{which}/coord"]
    if mode == "lags_hier":          # one worker per pod, FSDP blocks
        return _block(x[p], sdims[i], (d, m), (data, model))
    return _block(x[p * data + d], (-1, sdims[i][1]), (d, m), (data, model))


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CASES))
def test_two_steps_match_jax_build_train_step(runs, case):
    """2 steps against the reference on its ``make_host_mesh``: losses
    rtol 1e-5; the gathered parameters rtol 1e-4 atol 1e-5; every rank
    the same; each rank's residual chunk (each tier) against its block of
    the reference's per-worker residual, rtol 1e-4 atol 1e-5."""
    which, arch, mode, _ = CASES[case]
    jres, ranks = runs[2], runs[3]
    sdims = jres[f"{case}/sdims"]
    got = ranks[0]
    assert got[f"{case}/n_workers"] == jres[f"{case}/n_workers"]
    np.testing.assert_allclose(
        [got[f"{case}/loss{t}"] for t in range(STEPS)],
        [jres[f"{case}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    n = len([k for k in jres if k.startswith(f"{case}/params")])
    assert n == len(sdims) and (sdims[:, 1] >= 0).sum() >= 4, sdims
    for i in range(n):
        np.testing.assert_allclose(got[f"{case}/params{i}"],
                                   jres[f"{case}/params{i}"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{case} leaf {i}")
    for res in ranks:
        for t in range(STEPS):
            assert res[f"{case}/loss{t}"] == got[f"{case}/loss{t}"]
        for i in range(n):
            np.testing.assert_array_equal(res[f"{case}/params{i}"],
                                          got[f"{case}/params{i}"])
    n_tiers = 2 if mode == "lags_hier2" else 1
    keys = [k for k in jres if k.startswith(f"{case}/ef")]
    assert len(keys) == (0 if mode == "dense" else n * n_tiers)
    for key in keys:
        i = int(key[len(f"{case}/ef"):]) % n
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(
                res[key][0], _worker_block(case, res, sdims, i, jres[key]),
                rtol=1e-4, atol=1e-5, err_msg=f"{key} rank {r}")


@pytest.mark.slow
@pytest.mark.parametrize("case", list(REPLICAS))
def test_replicas_of_each_chunk_are_bitwise_equal(runs, case):
    """The ranks that differ only on the replica axis hold the same
    parameter chunks, bit for bit: the data replicas of each model chunk,
    and on the pod mesh each pod's chunk after the cross-pod exchange."""
    which = CASES[case][0]
    ranks = runs[3]
    keep = [a not in REPLICAS[case] for a in ("pod", "data")] + [True]
    n = len([k for k in ranks[0] if k.startswith(f"{case}/chunk")])
    groups: dict = {}
    for res in ranks:
        c = tuple(int(v) for v, k in zip(res[f"{which}/coord"], keep) if k)
        groups.setdefault(c, []).append(res)
    assert n and all(len(g) > 1 for g in groups.values()), groups.keys()
    for group in groups.values():
        for res in group[1:]:
            for i in range(n):
                np.testing.assert_array_equal(
                    _bits(res[f"{case}/chunk{i}"]),
                    _bits(group[0][f"{case}/chunk{i}"]), err_msg=str(i))


@pytest.mark.slow
@pytest.mark.parametrize("case", WAVE_PARITY)
def test_wave_equals_off_bitwise(runs, case):
    """``wave`` (each wave's exchange launched by the autograd hooks
    while the recurrent layers' backward collectives run over 'model',
    inside the recomputed periods) == ``off``, bit for bit: losses,
    parameter chunks and residuals on every rank."""
    for res in runs[3]:
        keys = [k[len(case) + 1:] for k in res if k.startswith(case + "/")
                and not k.startswith(case + "/wave")]
        assert len(keys) >= STEPS + 8
        for k in keys:
            np.testing.assert_array_equal(
                _bits(res[f"{case}/wave/{k}"]), _bits(res[f"{case}/{k}"]),
                err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("arch", ONE_ARCHS)
def test_one_by_one_mesh_is_bitwise_the_data_only_step(runs, arch):
    """On a gloo world of one, 3 bf16 ``lags_dp`` + kernel steps of the
    xLSTM and Jamba smoke models on ("data", "model") = 1 × 1 (every
    'model' boundary of the recurrent layers the identity, the sums over
    one rank) leave the losses, parameters and residuals of the
    data-only mesh's steps, bit for bit, ``off`` and ``wave``."""
    res = runs[4]
    want = f"{arch}/data/off"
    assert not bool(res[want + "/dtensor"])
    n = len([k for k in res if k.startswith(want + "/leaf")])
    assert n > 8
    for key in (f"{arch}/data/wave", f"{arch}/1x1/off", f"{arch}/1x1/wave"):
        assert bool(res[key + "/dtensor"]) == ("1x1" in key)
        for t in range(3):
            assert res[f"{key}/loss{t}"] == res[f"{want}/loss{t}"], key
        for i in range(n):
            np.testing.assert_array_equal(
                _bits(res[f"{key}/leaf{i}"]), _bits(res[f"{want}/leaf{i}"]),
                err_msg=f"{key} leaf {i}")


@pytest.mark.parametrize("mode", ["dense", "lags_dp", "slgs", "lags_hier2",
                                  "lags_hier"])
@pytest.mark.parametrize("arch", ["xlstm_1_3b", "paper_lstm_ptb",
                                  "jamba_v0_1_52b"])
def test_check_tensor_parallel_admits_the_recurrent_families(arch, mode):
    """On a mesh with a 'model' axis xLSTM and the paper's LSTM (``ssm``)
    and Jamba (``hybrid``) pass ``check_tensor_parallel`` under every
    mode (since item 7g it refuses no health quantity either:
    ``test_torch_tp_families.py`` runs them at 1 × 1)."""
    import types
    from repro_torch.configs import base
    from repro_torch.launch import train as LT
    cfg = base.get_smoke_config(arch)
    assert cfg.family in ("ssm", "hybrid")
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: 2)
    LT.check_tensor_parallel(cfg, mesh, mode)
