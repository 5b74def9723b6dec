"""Tensor parallelism, first part: the port's ('data', 'model') mesh
against the reference's ``make_host_mesh(data=2, model=2)``.

The reference runs its distributed step manual over the data axes and
leaves 'model' to GSPMD, which lays each parameter out by
``repro.sharding.rules``; the port lays the same specs out as
``DTensor``s over the mesh's 'model' dim (``repro_torch.sharding``).

Contracts:
  * ``sharding.rules.spec_for_leaf`` equals the reference's for every
    parameter of every config in ``ARCH_IDS`` at full size, on the
    production meshes ({data: 16, model: 16} and {pod: 2, data: 16,
    model: 16}), under both tensor-parallel priorities, with and without
    FSDP over 'data'; and on cache-like leaves (``cache_batch`` over the
    data axes, ``cache_seq`` over 'model');
  * four gloo ranks (data 2 × model 2, the SMALL config of
    ``test_torch_distributed.py``, f32) beside one JAX subprocess on
    ``make_host_mesh(data=2, model=2)``, from the same weights and
    batches: 3 steps of ``dense``, ``lags_dp`` (xla and kernel
    backends), ``lags_dp`` + momentum correction 0.9 and ``lags_dp`` /
    ``async1`` match the reference's ``build_train_step``: losses rtol
    1e-5; the gathered parameters and each rank's residuals, velocities
    and pending updates (its chunk of the reference's per-worker state)
    rtol 1e-4 atol 1e-5; the two data replicas of each model chunk equal
    bit for bit;
  * in the same spawn: ``wave`` == ``off`` and ``kernel`` == ``xla`` bit
    for bit; the exchange on each rank's chunk (``BlockLAGSExchange(
    row_axes=...)``) equal, bit for bit, to the chunk of the full-leaf
    exchange with the same ``shard_dims``, on leaves whose chunks fall
    on block boundaries, straddle them, or are not sharded; ``distribute``
    / ``gather`` round trip; ``Session.run``'s checkpoint holds the full
    tensors; ``slgs``, ``lags_hier2``, ``lags_hier`` and the ('pod',
    'data', 'model') mesh build (``test_torch_tp_modes.py`` holds them
    to the reference), the data axes of that mesh the group of one model
    index; every family and plane the slice does not cover raises
    ``NotImplementedError`` naming ROADMAP.md queue 1 item 7.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA, MODEL, STEPS, B, S = 2, 2, 3, 8, 16
WORLD = DATA * MODEL
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, compression_ratio=8.0, dtype="float32",
             param_dtype="float32")
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16)
# against the reference: name -> (mode, mc, pipeline, port backend)
MODES = {"dense": ("dense", 0.0, "off", "xla"),
         "lags_dp_xla": ("lags_dp", 0.0, "off", "xla"),
         "lags_dp_kernel": ("lags_dp", 0.0, "off", "kernel"),
         "lags_dp_mc": ("lags_dp", 0.9, "off", "kernel"),
         "lags_dp_async1": ("lags_dp", 0.0, "async1", "kernel")}
# wave == off, bitwise: name -> (mode, backend); 2 steps
WAVE_PARITY = {"dense": ("dense", "xla"), "lags_dp": ("lags_dp", "kernel")}
WAVE_BYTES = 2048
# the local-row exchange: leaf -> (shape, sharded dim or None, k)
EX_LEAVES = {"aligned": ((8, 96), 0, 40),       # chunks of 6 blocks
             "straddle": ((6, 50), 0, 30),      # 150-entry chunks
             "inner_dim": ((20, 4, 8), 1, 64),  # dim 1 laid first
             "narrow": ((4, 30), 1, 9),         # chunk < one block
             "whole": ((10, 7), None, 11)}      # not sharded
EX_BLOCK = 64
# what the slice does not cover: case -> RunConfig kwargs
REFUSED = {"moe_family": dict(mode="lags_hier"),
           "health": dict(mode="lags_dp", health_every=1)}
# what the first part refused and the second builds: case -> (RunConfig
# kwargs, its worker count)
ADMITTED = {"lags_hier": (dict(mode="lags_hier"), 1),
            "lags_hier2": (dict(mode="lags_hier2"), 2),
            "slgs": (dict(mode="slgs"), 2),
            "pod_mesh": (dict(mode="lags_dp"), 2)}

JAX_SCRIPT = """
import dataclasses, sys
import jax, numpy as np
from repro import api, compat
from repro.configs import base
from repro.launch import mesh as M, train as TR

inp = np.load(sys.argv[1])
cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                          **SMALL)
mesh = M.make_host_mesh(data=DATA, model=MODEL)
out = {}
done = {}
for name, (mode, mc, pipeline, _) in MODES.items():
    twin = done.setdefault((mode, mc, pipeline), name)
    if twin != name:                      # the reference's one backend
        for k in [k for k in out if k.startswith(twin + "/")]:
            out[name + k[len(twin):]] = out[k]
        continue
    run = api.RunConfig(mode=mode, momentum_correction=mc, donate=False,
                        pipeline=pipeline, wave_target_bytes=WAVE_BYTES,
                        **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    state, _ = TR.init_state(cfg, mesh, method=mode, pipeline=pipeline,
                             momentum_correction=mc)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            batch = {"tokens": inp["tokens"][t], "labels": inp["labels"][t]}
            state, metrics = step(state, batch)
            out[f"{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef", "pending"):
        for i, x in enumerate(jax.tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = np.asarray(x)
    specs = jax.tree.leaves(meta["pspecs"], is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    out["sdims"] = np.array([next((i for i, e in enumerate(s)
                                   if e == "model"), -1) for s in specs])
np.savez(sys.argv[2], **out)
print("OK jax")
"""

RANK_SCRIPT = """
import dataclasses, os, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import api, tree
from repro_torch.configs import tinyllama_1_1b
from repro_torch.core import lags as TL
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TT
from repro_torch.sharding import dtensor as D, rules

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", WORLD, rank, device="cpu")
mesh = M.make_mesh(model=MODEL, device="cpu")
assert mesh.mesh_dim_names == ("data", "model")
assert mesh.mesh.tolist() == [[0, 1], [2, 3]]
d_rank, m_rank = divmod(rank, MODEL)
data_axes = M.worker_axes(mesh, ("data",))
rows = M.worker_axes(mesh, ("model",))
assert dist.get_process_group_ranks(data_axes.group) == [m_rank,
                                                         MODEL + m_rank]
out = {}

# the exchange on this rank's chunks of its data worker's leaves
for use_kernel in (False, True):
    ks = {k: v[2] for k, v in EX_LEAVES.items()}
    sdims = {k: () if v[1] is None else (v[1],)
             for k, v in EX_LEAVES.items()}
    ex = TL.BlockLAGSExchange(ks=ks, block_size=EX_BLOCK,
                              use_kernel=use_kernel, shard_dims=sdims,
                              row_axes=rows)

    def chunk(x, k):
        dim = EX_LEAVES[k][1]
        return x if dim is None else x.chunk(MODEL, dim)[m_rank].contiguous()
    e = {k: chunk(torch.from_numpy(inp[f"e0/{k}"][d_rank]), k)
         for k in EX_LEAVES}
    for t in range(2):
        u = {k: chunk(torch.from_numpy(inp[f"u{t}/{k}"][d_rank]), k)
             for k in EX_LEAVES}
        m, e = ex.exchange(u, e, data_axes)
        for k in EX_LEAVES:
            out[f"rows{int(use_kernel)}/{t}/mean/{k}"] = m[k].numpy()
            out[f"rows{int(use_kernel)}/{t}/ef/{k}"] = e[k].numpy()

cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), **SMALL)
leaves, treedef = tree.flatten(TT.abstract_params(cfg))
start = tree.unflatten(treedef, [inp[f"param{i}"]
                                 for i in range(len(leaves))])


def batch_at(t):
    return {"tokens": torch.from_numpy(inp["tokens"][t]),
            "labels": torch.from_numpy(inp["labels"][t])}


def train(name, steps, **kw):
    run = api.RunConfig(wave_target_bytes=WAVE_BYTES, **RUN_KW, **kw)
    sess = api.Session(cfg, run, mesh=mesh)
    module = TT.from_jax_params(start, cfg, device="cpu")
    state, _ = sess.init_state(params=module.params)
    assert all(D.is_dtensor(p) for p in tree.leaves(state["params"]))
    for t in range(steps):
        state, metrics = sess.step_fn(state, batch_at(t))
        out[f"{name}/loss{t}"] = float(metrics["loss"])
        for p in tree.leaves(state["params"]):
            assert p.grad is None and not p._post_accumulate_grad_hooks
    for i, x in enumerate(tree.leaves(D.gather(state["params"]))):
        out[f"{name}/params{i}"] = x.numpy()
    for i, x in enumerate(tree.leaves(state["params"])):
        out[f"{name}/chunk{i}"] = x.to_local().detach().clone().numpy()
    for part in ("ef", "pending"):
        for i, x in enumerate(tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = x.clone().numpy()
    for i, x in enumerate(tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = x.clone().numpy()
    specs = tree.flatten_up_to(treedef, sess.meta["pspecs"])
    out["sdims"] = np.array([next((i for i, e in enumerate(s)
                                   if e == "model"), -1) for s in specs])
    waves = sess.meta["waves"]
    out[f"{name}/n_waves"] = waves.n_waves if waves else 0
    return sess


for name, (mode, mc, pipeline, backend) in MODES.items():
    train(name, STEPS, mode=mode, momentum_correction=mc,
          pipeline=pipeline, selection_backend=backend)
for name, (mode, backend) in WAVE_PARITY.items():
    for pipeline in ("off", "wave"):
        train(f"parity/{name}/{pipeline}", 2, mode=mode,
              selection_backend=backend, pipeline=pipeline)

# distribute / gather: the full tree back, bit for bit
module = TT.from_jax_params(start, cfg, device="cpu")
specs = api.Session(cfg, api.RunConfig(mode="lags_dp"),
                    mesh=mesh).meta["pspecs"]
back = D.gather(D.distribute(module.params, specs, mesh))
out["roundtrip"] = np.array(all(
    torch.equal(a.detach(), b) for a, b in zip(tree.leaves(module.params),
                                                tree.leaves(back))))

# Session.run's checkpoint: the full tensors
from repro_torch.checkpoint import io as ckpt
sess = api.Session(cfg, api.RunConfig(mode="lags_dp", **RUN_KW), mesh=mesh)
state, _ = sess.init_state(params=TT.from_jax_params(start, cfg,
                                                     device="cpu").params)
ck_dir = os.path.join(os.path.dirname(out_path), f"ckpt{rank}")
state, _ = sess.run(batch_at, 1, state=state, out_dir=ck_dir,
                    print_fn=lambda *a: None)
full = D.gather(state["params"])
saved = ckpt.restore(os.path.join(ck_dir, "ckpt_final"),
                     {"params": full, "step": np.asarray(0, np.int32)})
out["ckpt_full"] = np.array(int(saved["step"]) == 1 and all(
    torch.equal(a, b) for a, b in zip(tree.leaves(saved["params"]),
                                      tree.leaves(full))))

# a mesh without a 'model' axis: plain tensors, as before
flat = M.make_mesh(device="cpu")
sess = api.Session(cfg, api.RunConfig(mode="lags_dp", **RUN_KW), mesh=flat)
state, _ = sess.init_state(params=TT.from_jax_params(start, cfg,
                                                     device="cpu").params)
state, _ = sess.step_fn(state, batch_at(0))
out["no_dtensor"] = np.array(sess.meta["pspecs"] is None and not any(
    D.is_dtensor(x) for x in tree.leaves(state["params"])
    + tree.leaves(state["ef"])))

# what the slice does not cover raises, naming its item
from repro_torch.autotune import profiler as PR
for case, call in (
        ("controller", lambda: api.Session(
            cfg, api.RunConfig(mode="lags_dp"), mesh=mesh).controller()),
        ("profile_model", lambda: PR.profile_model(cfg, mesh)),
        ("publisher", lambda: api.Session(
            cfg, api.RunConfig(mode="lags_dp"), mesh=mesh).run(
                batch_at, 1, publisher=object()))):
    try:
        call()
        out[f"refused/{case}"] = np.array("no error")
    except NotImplementedError as err:
        out[f"refused/{case}"] = np.array(str(err))
for case, kw in REFUSED.items():
    try:
        if case == "moe_family":
            # what stays refused of the MoE family: lags_hier's token
            # groups across ranks (4 rows on 2 pods x 2)
            from repro_torch.launch import train as TR
            TR.pod_auto_moe_groups(4, 2, 2)
        else:
            api.Session(cfg, api.RunConfig(**RUN_KW, **kw),
                        mesh=mesh).train_step()
        out[f"refused/{case}"] = np.array("no error")
    except NotImplementedError as err:
        out[f"refused/{case}"] = np.array(str(err))
pod_mesh = M.make_mesh(pod=2, model=MODEL, device="cpu")
assert pod_mesh.mesh_dim_names == ("pod", "data", "model")
# the worker group over the data axes beside 'model': one model index
out["pod_data_axes"] = np.array(dist.get_process_group_ranks(
    M.worker_axes(pod_mesh, M.data_axis_names(pod_mesh)).group))
for case, (kw, _) in ADMITTED.items():
    m = pod_mesh if case == "pod_mesh" else mesh
    meta = api.Session(cfg, api.RunConfig(**RUN_KW, **kw),
                       mesh=m).train_step()[2]
    out[f"admitted/{case}"] = np.array(meta["n_workers"])
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants() -> str:
    return "".join(f"{name} = {globals()[name]!r}\n" for name in (
        "DATA", "MODEL", "WORLD", "STEPS", "SMALL", "MODES", "RUN_KW",
        "WAVE_PARITY", "WAVE_BYTES", "EX_LEAVES", "EX_BLOCK", "REFUSED",
        "ADMITTED", "B", "S"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX subprocess and four gloo ranks, started together; returns
    (inputs, JAX results, per-rank port results)."""
    from repro.configs import base
    tmp = tmp_path_factory.mktemp("tp")
    cfg = dataclasses.replace(base.get_smoke_config("tinyllama_1_1b"),
                              **SMALL)
    params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(25)
    toks = rng.integers(0, SMALL["vocab"], (STEPS, B, S + 1)).astype(
        np.int32)
    inp = {f"param{i}": np.asarray(p)
           for i, p in enumerate(jax.tree.leaves(params))}
    inp.update(tokens=toks[..., :-1], labels=toks[..., 1:])
    for k, (shape, _, _) in EX_LEAVES.items():
        inp[f"e0/{k}"] = (0.05 * rng.standard_normal((DATA,) + shape)
                          ).astype(np.float32)
        for t in range(2):
            inp[f"u{t}/{k}"] = rng.standard_normal((DATA,) + shape).astype(
                np.float32)
    np.savez(tmp / "in.npz", **inp)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
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


def _chunk(x: np.ndarray, dim: int, m: int) -> np.ndarray:
    """Model rank ``m``'s chunk of ``x`` along ``dim`` (-1: all of it)."""
    return x if dim < 0 else np.split(x, MODEL, axis=dim)[m]


# -- the rules, pure Python ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str):
    """The reference's (shapes, logical axes) of the full-size config's
    parameters, in flatten order (``eval_shape``: nothing allocated)."""
    from repro.configs import base as JB
    from repro.launch import train as JTR
    sds, axes = JTR.model_shapes_and_axes(JB.get_config(arch))
    is_axes = lambda a: isinstance(a, tuple)   # noqa: E731
    return ([tuple(x.shape) for x in jax.tree.leaves(sds)],
            jax.tree.leaves(axes, is_leaf=is_axes))


MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [
    "llava_next_mistral_7b", "nemotron_4_340b", "seamless_m4t_large_v2",
    "llama3_8b", "granite_moe_3b_a800m", "gemma3_27b", "olmoe_1b_7b",
    "xlstm_1_3b", "jamba_v0_1_52b", "tinyllama_1_1b"])
def test_spec_for_leaf_matches_reference(arch, mesh):
    """Every parameter of the full-size config: the port's specs (under
    both priorities, with and without FSDP over 'data') equal the
    reference's, and the launch step's ``param_pspecs`` picks the
    config's priority as the reference's does."""
    from repro.configs import base as JB
    from repro.launch import train as JTR
    from repro.sharding import rules as JR
    from repro_torch.configs import base as TB
    from repro_torch.launch import train as TTR
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import rules as TR
    assert TB.ARCH_IDS == JB.ARCH_IDS and arch in TB.ARCH_IDS
    jcfg, tcfg = JB.get_config(arch), TB.get_config(arch)
    shapes, jaxes = _reference_leaves(arch)
    tparams = TT.abstract_params(tcfg)
    tleaves, treedef = tree.flatten(tparams)
    assert [tuple(p.shape) for p in tleaves] == shapes
    assert tree.flatten_up_to(treedef, TT.logical_axes(tcfg)) == jaxes
    sizes = MESHES[mesh]
    n_model = 0
    for prio in ("TP_PRIORITY", "TP_PRIORITY_EXPERTS"):
        assert getattr(TR, prio) == getattr(JR, prio)
        for fsdp in (None, "data"):
            kw = dict(tp_axis="model", fsdp_axis=fsdp,
                      tp_priority=getattr(TR, prio))
            got = tree.flatten_up_to(treedef, TR.tree_specs(
                tparams, TT.logical_axes(tcfg), sizes, **kw))
            want = [tuple(JR.spec_for_leaf(s, a, sizes, **kw))
                    for s, a in zip(shapes, jaxes)]
            assert got == want, (prio, fsdp)
            n_model += sum("model" in s for s in got)
    assert n_model > 0
    # the launch step's specs: the config's priority, FSDP under lags_hier
    assert TTR._tp_priority(tcfg) == JTR._tp_priority(jcfg)
    fake = type("Mesh", (), {"mesh_dim_names": tuple(sizes),
                             "size": lambda self, i: list(sizes.values())[i]})
    for mode, fsdp in (("lags_dp", None), ("lags_hier", "data")):
        want = [tuple(JR.spec_for_leaf(
            s, a, sizes, fsdp_axis=fsdp, tp_priority=JTR._tp_priority(jcfg)))
            for s, a in zip(shapes, jaxes)]
        assert tree.flatten_up_to(
            treedef, TTR.param_pspecs(tcfg, fake(), mode)) == want, mode


@pytest.mark.parametrize("sizes", [{"data": 4, "model": 2},
                                   {"pod": 2, "data": 16, "model": 16}])
def test_cache_specs_match_reference(sizes):
    """The batch-like pass: ``cache_batch`` over the data axes when they
    divide it (then 'model' goes to ``cache_seq`` or the heads), the
    rest as for parameters."""
    from repro.sharding import rules as JR
    from repro_torch.sharding import rules as TR
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    leaves = [((8, 64, 4, 16), ("cache_batch", "cache_seq", "kv_heads",
                                 "head_dim")),
              ((6, 64, 4, 16), ("cache_batch", "cache_seq", "kv_heads",
                                 "head_dim")),
              ((32, 48), ("cache_batch", "embed")),
              ((64, 3), ("cache_seq", None))]
    for shape, axes in leaves:
        for fsdp in (None, "data"):
            kw = dict(fsdp_axis=fsdp, data_axes=data_axes)
            assert TR.spec_for_leaf(shape, axes, sizes, **kw) == tuple(
                JR.spec_for_leaf(shape, axes, sizes, **kw)), (shape, fsdp)


def test_placements_and_local_shapes():
    """A spec's 'model' dim becomes the one ``Shard`` placement of the
    1-D 'model' sub-mesh; a leaf without one is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import dtensor as D
    from repro_torch.sharding import rules as TR
    assert TR.placements((None, "model", "data")) == (Shard(1),)
    assert TR.placements(("data", None)) == (Replicate(),)
    assert TR.placements((("pod", "model"), None)) == (Shard(0),)
    assert D.local_shape((6, 8, 2), (None, "model", None), 4) == (6, 2, 2)
    assert D.local_shape((6, 8), ("data", None), 4) == (6, 8)
    with pytest.raises(ValueError):
        D.local_shape((6, 8), ("model", None), 4)


def test_placements_and_local_shapes_on_data_by_model():
    """Under ``lags_hier`` a leaf lies on the pod's ('data', 'model')
    sub-mesh: one placement per axis, and its chunk splits on both
    dims (a 2-D block)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import dtensor as D
    from repro_torch.sharding import rules as TR
    axes = D.PARAM_AXES_FSDP
    assert axes == ("data", "model")
    assert TR.placements((None, "model", "data"), axes) == (Shard(2),
                                                            Shard(1))
    assert TR.placements(("data", None), axes) == (Shard(0), Replicate())
    assert TR.placements((None, None), axes) == (Replicate(), Replicate())
    sizes = {"data": 2, "model": 4}
    assert D.local_shape((6, 8, 2), (None, "model", "data"), sizes) == (
        6, 2, 1)
    assert D.local_shape((6, 8), ("data", None), sizes) == (3, 8)
    with pytest.raises(ValueError):
        D.local_shape((5, 8), ("data", "model"), sizes)


# -- four gloo ranks against the reference ---------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(MODES))
def test_three_steps_match_jax_build_train_step(runs, name):
    """3 steps on data 2 × model 2 against the reference's
    ``build_train_step`` on ``make_host_mesh(data=2, model=2)``: losses
    rtol 1e-5; gathered parameters rtol 1e-4 atol 1e-5, the same on every
    rank; each rank's residual, velocity and pending chunk against its
    chunk of the reference's worker state, rtol 1e-4 atol 1e-5; the two
    data replicas of each model chunk equal, bit for bit."""
    _, jres, ranks = runs
    sdims = jres["sdims"]
    got = ranks[0]
    np.testing.assert_array_equal(got["sdims"], sdims)
    assert (sdims >= 0).sum() == 9 and (sdims < 0).sum() == 3  # norms
    np.testing.assert_allclose(
        [got[f"{name}/loss{t}"] for t in range(STEPS)],
        [jres[f"{name}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    for res in ranks[1:]:
        assert [res[f"{name}/loss{t}"] for t in range(STEPS)] == \
            [got[f"{name}/loss{t}"] for t in range(STEPS)]
    for i in range(12):
        key = f"{name}/params{i}"
        np.testing.assert_allclose(got[key], jres[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[key], got[key], err_msg=key)
            np.testing.assert_array_equal(
                _bits(res[f"{name}/chunk{i}"]),
                _bits(ranks[(r + MODEL) % WORLD][f"{name}/chunk{i}"]))
            np.testing.assert_array_equal(
                res[f"{name}/chunk{i}"], _chunk(got[key], sdims[i],
                                                r % MODEL))
    mode, mc, pipeline, _ = MODES[name]
    for part, want in (("ef", 0 if mode == "dense" else 12),
                       ("mom", 12 if mc else 0),
                       ("pending", 12 if pipeline == "async1" else 0)):
        keys = [k for k in jres if k.startswith(f"{name}/{part}")]
        assert len(keys) == want, (part, keys)
        for key in keys:
            i = int(key[len(f"{name}/{part}"):])
            for r, res in enumerate(ranks):
                d, m = divmod(r, MODEL)
                np.testing.assert_allclose(
                    res[key][0], _chunk(jres[key][d], sdims[i], m),
                    rtol=1e-4, atol=1e-5, err_msg=f"{key} rank {r}")


def _bitwise_equal(res: dict, prefix_a: str, prefix_b: str) -> int:
    def keys(prefix):
        return sorted(k[len(prefix):] for k in res
                      if k.startswith(prefix) and k != prefix + "n_waves")
    assert keys(prefix_a) == keys(prefix_b)
    for k in keys(prefix_a):
        np.testing.assert_array_equal(_bits(res[prefix_a + k]),
                                      _bits(res[prefix_b + k]),
                                      err_msg=f"{prefix_a} {k}")
    return len(keys(prefix_a))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(WAVE_PARITY))
def test_wave_equals_off_bitwise_on_data_by_model(runs, name):
    """2 steps: ``wave`` (the gradients brought to their parameters'
    layout inside the hooks, several waves) == ``off`` bit for bit in
    losses, parameters and residuals on every rank."""
    _, _, ranks = runs
    for res in ranks:
        assert res[f"parity/{name}/wave/n_waves"] > 1
        n = _bitwise_equal(res, f"parity/{name}/off/",
                           f"parity/{name}/wave/")
        assert n == 2 + 12 * (2 if name == "dense" else 3)


@pytest.mark.slow
def test_kernel_backend_equals_xla_bitwise(runs):
    """``lags_dp`` with ``selection_backend="kernel"`` (the plain version
    of ``ef_select_pack`` on the CPU, on each rank's chunk rows) leaves
    the xla backend's losses, parameters and residuals, bit for bit."""
    _, _, ranks = runs
    for res in ranks:
        n = _bitwise_equal(res, "lags_dp_xla/", "lags_dp_kernel/")
        assert n == STEPS + 12 * 3


@pytest.mark.slow
@pytest.mark.parametrize("use_kernel", [0, 1])
def test_local_rows_equal_the_full_leaf_exchange_bitwise(runs, use_kernel):
    """Each rank's exchange on its chunks (``row_axes`` = 'model') gives
    its chunk of the full-leaf exchange with the same ``shard_dims`` over
    the two data workers, mean and residual, two steps: chunks on block
    boundaries, chunks whose blocks straddle a neighbour's (and one
    narrower than a block), and a leaf that is not sharded."""
    from repro_torch.core import lags as TL
    inp, _, ranks = runs
    ex = TL.BlockLAGSExchange(
        ks={k: v[2] for k, v in EX_LEAVES.items()}, block_size=EX_BLOCK,
        use_kernel=bool(use_kernel),
        shard_dims={k: () if v[1] is None else (v[1],)
                    for k, v in EX_LEAVES.items()})
    e = {k: torch.from_numpy(inp[f"e0/{k}"]) for k in EX_LEAVES}
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"]) for k in EX_LEAVES}
        mean, e = ex.exchange(u, e, None)
        for r, res in enumerate(ranks):
            d, m = divmod(r, MODEL)
            for k, (_, dim, _) in EX_LEAVES.items():
                dim = -1 if dim is None else dim
                tag = f"rows{use_kernel}/{t}"
                np.testing.assert_array_equal(
                    _bits(res[f"{tag}/mean/{k}"]),
                    _bits(_chunk(mean[k].numpy(), dim, m)),
                    err_msg=f"mean {k} rank {r} step {t}")
                np.testing.assert_array_equal(
                    _bits(res[f"{tag}/ef/{k}"]),
                    _bits(_chunk(e[k][d].numpy(), dim, m)),
                    err_msg=f"ef {k} rank {r} step {t}")
    assert all(float(x.abs().sum()) > 0 for x in e.values())


@pytest.mark.slow
def test_distribute_gather_and_checkpoint_hold_the_full_tensors(runs):
    """``gather(distribute(params))`` is the tree itself, bit for bit, and
    ``Session.run``'s checkpoint on the model axis holds the gathered
    full tensors in the reference's format."""
    _, _, ranks = runs
    for res in ranks:
        assert bool(res["roundtrip"]) and bool(res["ckpt_full"])


@pytest.mark.slow
@pytest.mark.parametrize("case", list(REFUSED) + [
    "controller", "profile_model", "publisher"])
def test_what_the_slice_does_not_cover_raises_naming_item_7(runs, case):
    """The MoE token groups across ranks, the health quantities, the
    re-planning controller, ``profile_model`` and a stream publisher
    raise ``NotImplementedError`` on a mesh with a 'model' axis, naming
    their part of item 7; nothing falls back to a gathered leaf."""
    _, _, ranks = runs
    for res in ranks:
        msg = str(res[f"refused/{case}"])
        assert "item 7" in msg and "tensor-parallel" in msg, msg


@pytest.mark.slow
@pytest.mark.parametrize("case", list(ADMITTED))
def test_the_modes_and_the_pod_mesh_of_the_second_part_build(runs, case):
    """What the first part refused builds: ``lags_hier`` (one worker on a
    single pod), ``lags_hier2`` and ``slgs`` on ('data', 'model'), and
    ``lags_dp`` on ('pod', 'data', 'model') = 2 × 1 × 2, each with the
    reference's worker count."""
    _, _, ranks = runs
    for res in ranks:
        assert int(res[f"admitted/{case}"]) == ADMITTED[case][1]


@pytest.mark.slow
def test_a_mesh_without_a_model_axis_creates_no_dtensor(runs):
    """``make_mesh()`` without ``model`` is the data-only layout: no
    specs, plain parameters and residuals after a step."""
    _, _, ranks = runs
    for res in ranks:
        assert bool(res["no_dtensor"])


@pytest.mark.slow
def test_data_axes_of_a_pod_mesh_with_a_model_axis_are_one_model_index(
        runs):
    """On ("pod", "data", "model") = 2 × 1 × 2, the exchange's worker
    axes over 'pod' and 'data' are the group of the ranks of this rank's
    model index, pod-major."""
    _, _, ranks = runs
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["pod_data_axes"],
                                      [r % MODEL, MODEL + r % MODEL])