"""Tensor parallelism for the other families, first part: the MoE layer
on 'model' (the F and the E layout, ``moe_forward_ep``), the
encoder-decoder and the VLM, against the reference.

One module-scoped start of every process: two gloo ranks at model 2
and one JAX subprocess on a 2-device host mesh for the layer alone;
four gloo ranks (data 2 × model 2, then pod 2 × data 1 × model 2) and
one JAX subprocess a model family on ``make_host_mesh`` for the train
step; a gloo world of one for the 1 × 1 mesh.  The same numpy weights and batches on both sides: each model's
smoke config in f32, 32 tokens a sequence (the VLM's 8 patches among
them, the encoder-decoder's 8 frames beside them).

Contracts:
  * the layer alone, Granite's leaves (F layout) and OLMoE's (E
    layout), at groups 1 and 2: the port's output, aux and the
    gradients of ``sum(out·w) + aux`` with respect to x, the router and
    every expert leaf equal the reference's ``moe_forward`` /
    ``moe_forward_grouped`` under ``jax.grad``, rtol and atol 1e-5; the
    port's ``moe_forward_ep`` (every leaf split on E) equals the
    reference's (``shard_map`` over 'model'); with the aux loss counted
    once a rank, or the tokens' gradient left unreduced, the gradients
    leave that tolerance;
  * the train step: 2 steps of every case of ``CASES`` match the
    reference's ``build_train_step``: losses rtol 1e-5 and the same on
    every rank; the gathered parameters rtol 1e-4 atol 1e-5 and the
    same on every rank; each rank's residual chunk against its block of
    the reference's per-worker residual, rtol 1e-4 atol 1e-5; the data
    replicas of each chunk bit for bit where the mode keeps them, and
    ``wave`` == ``off`` bit for bit on Granite's ``lags_dp``;
  * on ("data", "model") = 1 × 1 (a world of one), 3 bf16 ``lags_dp``
    steps of Granite and OLMoE are bitwise the data-only mesh's;
  * ``check_tensor_parallel`` admits the ``moe``, ``audio`` and ``vlm``
    families under every mode, and ``ssm`` and ``hybrid`` (item 7e's
    second part) but for their health quantities; the MoE token groups
    across ranks stay refused, naming item 7e's third part.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 2, 8, 32
F32 = dict(dtype="float32", param_dtype="float32")
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16, ratio_inner=4.0,
              inner_compressor="topk_block")
# the layer alone: (batch, tokens) of x, the token groups, and the archs
# whose smoke MoE leaves it takes (Granite: F layout; OLMoE: E layout)
LAYER_X, GROUPS = (2, 32), (1, 2)
LAYER_ARCHS = {"granite_moe_3b_a800m": "ffn", "olmoe_1b_7b": "experts"}
LAYER_FAULTS = ("aux_per_rank", "tokens_unreduced")
# mesh -> (pod, data, model)
MESHES = {"dm": (1, 2, 2), "pdm": (2, 1, 2)}
# case -> (mesh, arch, mode, port backend)
CASES = {
    "dm/granite/dense": ("dm", "granite_moe_3b_a800m", "dense", "xla"),
    "dm/granite/lags_dp": ("dm", "granite_moe_3b_a800m", "lags_dp",
                           "kernel"),
    "dm/granite/lags_hier": ("dm", "granite_moe_3b_a800m", "lags_hier",
                             "kernel"),
    "dm/olmoe/dense": ("dm", "olmoe_1b_7b", "dense", "xla"),
    "dm/olmoe/lags_dp": ("dm", "olmoe_1b_7b", "lags_dp", "kernel"),
    "dm/olmoe/lags_hier": ("dm", "olmoe_1b_7b", "lags_hier", "kernel"),
    "dm/olmoe/slgs": ("dm", "olmoe_1b_7b", "slgs", "xla"),
    "dm/olmoe/lags_hier2": ("dm", "olmoe_1b_7b", "lags_hier2", "xla"),
    "dm/seamless/lags_dp": ("dm", "seamless_m4t_large_v2", "lags_dp",
                            "kernel"),
    "dm/llava/lags_dp": ("dm", "llava_next_mistral_7b", "lags_dp",
                         "kernel"),
    "pdm/granite/lags_hier": ("pdm", "granite_moe_3b_a800m", "lags_hier",
                              "kernel"),
}
ARCHS = sorted({c[1] for c in CASES.values()})
# the JAX subprocesses of the train step: the archs each one runs
JAX_SPLIT = (("granite_moe_3b_a800m",), ("olmoe_1b_7b",),
             ("seamless_m4t_large_v2", "llava_next_mistral_7b"))
# wave == off, bit for bit
WAVE_PARITY = ("dm/granite/lags_dp",)
WAVE_BYTES = 2048
# the ranks that hold one chunk's replicas: case -> the axes over which
# the chunk must be equal
REPLICAS = {"dm/granite/lags_dp": "data", "dm/olmoe/lags_dp": "data",
            "dm/olmoe/slgs": "data", "dm/olmoe/lags_hier2": "data",
            "dm/seamless/lags_dp": "data", "dm/llava/lags_dp": "data",
            "pdm/granite/lags_hier": "pod"}

LAYER_JAX = """
import functools, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import base
from repro.launch import mesh as M
from repro.models import moe

inp, out_path = np.load(sys.argv[1]), sys.argv[2]
mesh = M.make_host_mesh(data=1, model=2)
out = {}
for arch in LAYER_ARCHS:
    cfg = base.get_smoke_config(arch)
    p = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith(arch + "/w_") or k == arch + "/router"}
    x, w = jnp.asarray(inp[arch + "/x"]), jnp.asarray(inp[arch + "/w"])
    kw = dict(top_k=cfg.moe_top_k, activation=cfg.activation)
    for groups in GROUPS:
        def f(p, x):
            o, a = moe.moe_forward_grouped(p, x, groups=groups, **kw)
            return (o * w).sum() + a, (o, a)
        (_, (o, a)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p, x)
        key = f"{arch}/g{groups}"
        out[key + "/out"], out[key + "/aux"] = np.asarray(o), np.asarray(a)
        out[key + "/grad_x"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{key}/grad_{k}"] = np.asarray(v)
    with compat.set_mesh(mesh):
        o, a = jax.jit(functools.partial(moe.moe_forward_ep, **kw))(p, x)
    out[arch + "/ep/out"], out[arch + "/ep/aux"] = np.asarray(o), \\
        np.asarray(a)
np.savez(out_path, **out)
print("OK jax layer")
"""

LAYER_RANK = """
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import base
from repro_torch.launch import mesh as M, train as TR
from repro_torch.models import moe as TM
from repro_torch.sharding import dtensor as D, rules

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", 2, rank, device="cpu")
mesh = M.make_mesh(model=2, device="cpu")
sub = D.sub_mesh(mesh)
out = {}
real = {"tokens": TM._tokens_local, "aux": TM._aux_share}
faults = {
    "aux_per_rank": ("aux", lambda aux, mesh: aux),
    "tokens_unreduced": ("tokens",
                         lambda x, mesh, partial: real["tokens"](x, mesh,
                                                                 False))}


def full(t):
    return t.full_tensor().detach().numpy() if isinstance(t, DTensor) \\
        else t.detach().numpy()


def layer(arch, cfg, p, groups, key, ep=False):
    x = DTensor.from_local(torch.from_numpy(inp[arch + "/x"]).clone(), sub,
                           (Replicate(),)).requires_grad_()
    w = torch.from_numpy(inp[arch + "/w"])
    kw = dict(top_k=cfg.moe_top_k, activation=cfg.activation)
    with implicit_replication():
        if ep:
            o, a = TM.moe_forward_ep(p, x, **kw)
            out[key + "/out"], out[key + "/aux"] = full(o), full(a)
            return
        o, a = TM.moe_forward_auto(p, x, groups=groups, **kw)
        names = sorted(p)
        grads = torch.autograd.grad((o * w).sum() + a,
                                    [x] + [p[k] for k in names])
    out[key + "/out"], out[key + "/aux"] = full(o), full(a)
    out[key + "/grad_x"] = full(grads[0])
    for k, g in zip(names, grads[1:]):
        out[f"{key}/grad_{k}"] = full(g)


for arch in LAYER_ARCHS:
    cfg = base.get_smoke_config(arch)
    leaves = {k[len(arch) + 1:]: torch.from_numpy(v) for k, v in inp.items()
              if k.startswith(arch + "/w_") or k == arch + "/router"}
    _, axes = TM.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts,
                           gated=cfg.gated_ffn)
    specs = rules.tree_specs(leaves, axes, rules.mesh_axis_sizes(mesh),
                             tp_priority=TR._tp_priority(cfg))
    p = D.distribute(leaves, specs, mesh)
    out[arch + "/layout"] = np.array(TM.tp_layout(p))
    for groups in GROUPS:
        layer(arch, cfg, p, groups, f"{arch}/g{groups}")
    for name, (which, fn) in faults.items():
        setattr(TM, {"aux": "_aux_share", "tokens": "_tokens_local"}[which],
                fn)
        try:
            layer(arch, cfg, p, 1, f"{arch}/fault/{name}")
        finally:
            TM._tokens_local, TM._aux_share = real["tokens"], real["aux"]
    # expert parallelism: every expert leaf split on E
    by_e = rules.tree_specs(leaves, axes, rules.mesh_axis_sizes(mesh),
                            tp_priority=rules.TP_PRIORITY_EXPERTS)
    layer(arch, cfg, D.distribute(leaves, by_e, mesh), 1, arch + "/ep",
          ep=True)
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

archs, inp, out_path = sys.argv[1].split(","), np.load(sys.argv[2]), \\
    sys.argv[3]
is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
out = {}
for name, (which, arch, mode, _) in CASES.items():
    if arch not in archs:
        continue
    cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
    pod, data, model = MESHES[which]
    mesh = M.make_host_mesh(data=data, model=model, pod=pod)
    run = api.RunConfig(mode=mode, donate=False, **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    state, _ = TR.init_state(cfg, mesh, method=mode)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"{arch}/param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            batch = {k: inp[f"{arch}/{k}"][t] for k in BATCH_KEYS
                     if f"{arch}/{k}" in inp}
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
print("OK jax", archs)
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
                 for k in BATCH_KEYS if f"{arch}/{k}" in inp}
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
for arch in LAYER_ARCHS:
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

BATCH_KEYS = ("tokens", "labels", "frontend_embeds")


def _constants() -> str:
    names = ("S", "STEPS", "F32", "RUN_KW", "GROUPS", "LAYER_ARCHS",
             "MESHES", "CASES", "WAVE_PARITY", "WAVE_BYTES", "BATCH_KEYS")
    return "".join(f"{n} = {globals()[n]!r}\n" for n in names)


def _inputs() -> dict:
    """The weights and batches of every model, and the layer's leaves,
    tokens and cotangent, from seeds (numpy, and the reference's
    ``init_model``)."""
    from repro.configs import base
    from repro.models import moe as JM
    from repro.models import transformer as JT
    rng = np.random.default_rng(27)
    inp = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
        params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        for i, p in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param{i}"] = np.asarray(p)
        n_f = 0
        if cfg.frontend == "vision":
            n_f = min(cfg.n_frontend_tokens, S // 2)
            inp[f"{arch}/frontend_embeds"] = rng.standard_normal(
                (STEPS, B, n_f, cfg.d_model)).astype(np.float32)
        elif cfg.frontend == "audio":
            inp[f"{arch}/frontend_embeds"] = rng.standard_normal(
                (STEPS, B, max(S // 4, 1), cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab, (STEPS, B, S - n_f + 1)).astype(
            np.int32)
        inp[f"{arch}/tokens"], inp[f"{arch}/labels"] = (toks[..., :-1],
                                                        toks[..., 1:])
    for arch in LAYER_ARCHS:
        cfg = base.get_smoke_config(arch)
        leaves, _ = JM.init_moe(jax.random.PRNGKey(1), cfg.d_model, cfg.d_ff,
                                cfg.n_experts, np.float32,
                                gated=cfg.gated_ffn)
        for k, v in leaves.items():
            inp[f"{arch}/{k}"] = np.asarray(v)
        shape = LAYER_X + (cfg.d_model,)
        inp[f"{arch}/x"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"{arch}/w"] = rng.standard_normal(shape).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process, started together: the layer's JAX subprocess and
    its two gloo ranks; the train step's JAX subprocesses (``JAX_SPLIT``)
    and its four gloo ranks.  Returns (layer JAX results, the layer's
    ranks' results, step JAX results, the step's ranks' results)."""
    tmp = tmp_path_factory.mktemp("tp_families")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    head = _constants()

    def start(code, args, **extra):
        return subprocess.Popen(
            [sys.executable, "-c", head + textwrap.dedent(code)]
            + [str(a) for a in args], env=dict(env, **extra),
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    # the reference's CPU code at LLVM's lowest optimization level: a
    # third less compile time, the same results within the tolerances
    host = ("--xla_backend_optimization_level=0 "
            "--xla_force_host_platform_device_count=")
    procs = [start(LAYER_JAX, [tmp / "in.npz", tmp / "jax_layer.npz"],
                   XLA_FLAGS=host + "2")]
    for i, archs in enumerate(JAX_SPLIT):
        procs.append(start(STEP_JAX, [",".join(archs), tmp / "in.npz",
                                      tmp / f"jax_step{i}.npz"],
                           XLA_FLAGS=host + "4"))
    for r in range(2):
        procs.append(start(LAYER_RANK, [r, tmp / "store2", tmp / "in.npz",
                                        tmp / f"layer{r}.npz"],
                           OMP_NUM_THREADS="1"))
    procs.append(start(ONE_RANK, [tmp / "store1", tmp / "one.npz"],
                       OMP_NUM_THREADS="1"))
    for r in range(4):
        procs.append(start(STEP_RANK, [r, tmp / "store4", tmp / "in.npz",
                                       tmp / f"step{r}.npz"],
                           OMP_NUM_THREADS="1"))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"STDOUT:\n{so}\nSTDERR:\n{se}"
    step_jax = {}
    for i in range(len(JAX_SPLIT)):
        step_jax.update(np.load(tmp / f"jax_step{i}.npz"))
    return (dict(np.load(tmp / "jax_layer.npz")),
            [dict(np.load(tmp / f"layer{r}.npz")) for r in range(2)],
            step_jax,
            [dict(np.load(tmp / f"step{r}.npz")) for r in range(4)],
            dict(np.load(tmp / "one.npz")))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _layer_keys(jres, key: str) -> list:
    return sorted(k[len(key) + 1:] for k in jres if k.startswith(key + "/"))


@pytest.mark.slow
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("arch", list(LAYER_ARCHS))
def test_layer_output_aux_and_gradients_match_moe_forward(runs, arch,
                                                          groups):
    """The TP layer at model 2 (Granite's leaves in the F layout, OLMoE's
    in the E layout): output, aux and the gradients of ``sum(out·w) +
    aux`` with respect to x, the router and every expert leaf equal the
    reference's unsharded dispatch under ``jax.grad``, rtol and atol
    1e-5, on both ranks."""
    jres, ranks = runs[0], runs[1]
    key = f"{arch}/g{groups}"
    names = _layer_keys(jres, key)
    assert {"out", "aux", "grad_x", "grad_router", "grad_w_up",
            "grad_w_down", "grad_w_gate"} <= set(names), names
    for r, res in enumerate(ranks):
        assert str(res[f"{arch}/layout"]) == LAYER_ARCHS[arch]
        for k in names:
            np.testing.assert_allclose(res[f"{key}/{k}"], jres[f"{key}/{k}"],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key}/{k} rank {r}")


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(LAYER_ARCHS))
def test_moe_forward_ep_matches_the_reference(runs, arch):
    """``moe_forward_ep`` on leaves split on E over 'model' equals the
    reference's ``moe_forward_ep`` (``shard_map`` over 'model' on a
    2-device host mesh): output and aux, rtol and atol 1e-5."""
    jres, ranks = runs[0], runs[1]
    for res in ranks:
        for k in ("out", "aux"):
            np.testing.assert_allclose(res[f"{arch}/ep/{k}"],
                                       jres[f"{arch}/ep/{k}"], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("fault", LAYER_FAULTS)
@pytest.mark.parametrize("arch", list(LAYER_ARCHS))
def test_a_planted_gradient_fault_leaves_the_tolerance(runs, arch, fault):
    """The aux loss counted once a rank (its gradient not divided among
    the 'model' ranks), or the tokens' gradient left unreduced (declared
    ``Replicate``: each rank keeps its own share): the gradient it moves
    (the router's, x's) leaves the tolerance the sound layer meets,
    while the forward stays the reference's."""
    jres, ranks = runs[0], runs[1]
    key = f"{arch}/g1"
    moved = "grad_router" if fault == "aux_per_rank" else "grad_x"
    got = ranks[0][f"{arch}/fault/{fault}/{moved}"]
    np.testing.assert_allclose(ranks[0][f"{arch}/fault/{fault}/out"],
                               jres[f"{key}/out"], rtol=1e-5, atol=1e-5)
    assert not np.allclose(got, jres[f"{key}/{moved}"], rtol=1e-5,
                           atol=1e-5), f"{fault} stayed inside the tolerance"


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
    """The ranks that differ only on the replica axes hold the same
    parameter chunks, bit for bit: the data replicas of each model chunk,
    and on the pod mesh each pod's block after the cross-pod exchange."""
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
    """``wave`` (each wave's exchange launched by the autograd hooks,
    the MoE layers' local path inside the recomputed periods) == ``off``,
    bit for bit: losses, parameter chunks and residuals on every rank."""
    for res in runs[3]:
        keys = [k[len(case) + 1:] for k in res if k.startswith(case + "/")
                and not k.startswith(case + "/wave")]
        assert len(keys) >= STEPS + 8
        for k in keys:
            np.testing.assert_array_equal(
                _bits(res[f"{case}/wave/{k}"]), _bits(res[f"{case}/{k}"]),
                err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("arch", list(LAYER_ARCHS))
def test_one_by_one_mesh_is_bitwise_the_data_only_step(runs, arch):
    """On a gloo world of one, 3 bf16 ``lags_dp`` + kernel steps of the
    MoE smoke model on ("data", "model") = 1 × 1 (the leaves ``DTensor``s
    over a 'model' axis of one rank: the sum over 'model' an identity,
    the aux gradient's share 1/1) leave the losses, parameters and
    residuals of the data-only mesh's steps, bit for bit, ``off`` and
    ``wave``."""
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


def _model_mesh():
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: 2)


@pytest.mark.parametrize("mode", ["dense", "lags_dp", "slgs", "lags_hier2",
                                  "lags_hier"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "olmoe_1b_7b",
                                  "seamless_m4t_large_v2",
                                  "llava_next_mistral_7b"])
def test_check_tensor_parallel_admits_moe_audio_and_vlm(arch, mode):
    """On a mesh with a 'model' axis the MoE family, the encoder-decoder
    and the VLM pass ``check_tensor_parallel`` under every mode."""
    from repro_torch.configs import base
    from repro_torch.launch import train as LT
    cfg = base.get_smoke_config(arch)
    assert cfg.family in ("moe", "audio", "vlm")
    LT.check_tensor_parallel(cfg, _model_mesh(), mode)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "paper_lstm_ptb",
                                  "jamba_v0_1_52b"])
def test_check_tensor_parallel_refuses_the_recurrent_families(arch):
    """Since item 7e's second part, xLSTM and the paper's LSTM (``ssm``)
    and Jamba (``hybrid``) pass on a 'model' axis; what it still refuses
    for them is the health quantities, naming item 7g
    (``tests/test_torch_tp_recurrent.py`` holds their training to the
    reference)."""
    from repro_torch.configs import base
    from repro_torch.launch import train as LT
    cfg = base.get_smoke_config(arch)
    assert cfg.family in ("ssm", "hybrid")
    LT.check_tensor_parallel(cfg, _model_mesh(), "lags_dp")
    with pytest.raises(NotImplementedError,
                       match="item 7g.*tensor-parallel"):
        LT.check_tensor_parallel(cfg, _model_mesh(), "lags_dp", health=True)


def test_moe_token_groups_across_ranks_stay_refused():
    """Under ``lags_hier`` on 2 pods × 2, a batch of 4 rows puts each
    pod's 2 rows in one MoE token group across its ranks: the step
    refuses it, naming item 7e's third part."""
    from repro_torch.launch import train as LT
    assert LT.pod_auto_moe_groups(8, 2, 2) == 2
    with pytest.raises(NotImplementedError,
                       match="item 7e's third part.*tensor-parallel"):
        LT.pod_auto_moe_groups(4, 2, 2)
