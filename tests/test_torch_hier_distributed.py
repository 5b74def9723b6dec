"""The port's hierarchy on its distributed surface: four gloo ranks on a
(pod = 2, data = 2) mesh (``make_mesh(pod=2)``), beside one JAX
subprocess on ``make_host_mesh(data=2, model=1, pod=2)``; the same
weights and numpy batches as ``test_torch_distributed.py``, fp32.

Contracts:
  * the distributed ``SparseHierLAGSExchange`` (inner picks gathered
    over each pod's 'data' group, the pod means' picks over 'pod') equals
    the port's simulation path at P = 4, n_inner = 2 bit for bit, mean
    and both residuals, two steps with the residuals fed back, both
    selection backends;
  * 3 steps of ``lags_hier2`` and ``lags_hier`` through ``Session(cfg,
    run, mesh=...).train_step()`` (``off``, ``async1`` + momentum
    correction 0.9, and ``lags_hier``'s post-backward ``wave``; and the
    Granite MoE model under ``lags_hier``, whose token groups follow the
    reference's pod x data grouping, at a global batch of 4 too, where
    each pod's rows make one group across its ranks (gathered over
    'data', ``models.moe.TokenSpan``), and under ``lags_dp``, one group
    of local tokens) match the
    reference's ``build_train_step`` at the battery's tolerances: losses
    rtol 1e-5, parameters, both tiers' residuals, velocities and pending
    updates rtol 1e-4 atol 1e-5 (``lags_hier``'s per-pod gradient is the
    mean of its ranks' here and one gradient there: allclose only);
    parameters equal on every rank bit for bit;
  * ``wave`` equals ``off`` bit for bit (2 steps, several waves), and
    ``async1`` reproduces the sync prefix ``[L0, L0, L1]`` on one
    repeated batch;
  * ``lags_dp`` on the pod mesh equals ``lags_dp`` on the flat 4-rank
    mesh bit for bit (the (pod, data) group is the ranks in order);
  * ``lags_hier`` holds its parameters over 'data' (FSDP, a ``DTensor``
    each on the pod's 'data' sub-mesh): its bytes at rest a card about
    half the replicated layout's (the rank script gathers the
    parameters and the blocks of its state for the comparisons above).
"""
import os
import textwrap

import numpy as np
import pytest
from test_torch_spawn import COMPILE_ONCE, Lazy, Spawned, load

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.models import transformer as JT  # noqa: E402
from repro_torch.api import registry as TR  # noqa: E402

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, PODS, STEPS, B, S = 4, 2, 3, 8, 16
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=64, head_dim=16, compression_ratio=8.0, dtype="float32",
             param_dtype="float32")
RUN_KW = dict(lr=0.1, chunk=16, loss_chunk=16, ratio_inner=4.0,
              inner_compressor="topk_block")
# lags_hier's bytes at rest a card over the replicated layout's
REST_BAND = (0.5, 0.55)
# the models, each a smoke config cut to SMALL's widths
ARCHS = ("tinyllama_1_1b", "granite_moe_3b_a800m")
# against the reference: name -> (mode, mc, pipeline, one repeated batch,
# model)
REF_MODES = {"hier2": ("lags_hier2", 0.0, "off", False, "tinyllama_1_1b"),
             "hier": ("lags_hier", 0.0, "off", False, "tinyllama_1_1b"),
             "hier2_async1_mc": ("lags_hier2", 0.9, "async1", True,
                                 "tinyllama_1_1b"),
             "hier_async1_mc": ("lags_hier", 0.9, "async1", True,
                                "tinyllama_1_1b"),
             "hier_wave": ("lags_hier", 0.0, "wave", False,
                           "tinyllama_1_1b"),
             "moe_hier": ("lags_hier", 0.0, "off", False,
                          "granite_moe_3b_a800m"),
             "moe_dp": ("lags_dp", 0.0, "off", False,
                        "granite_moe_3b_a800m"),
             "moe_span": ("lags_hier", 0.0, "off", False,
                          "granite_moe_3b_a800m")}
# the global batch's rows where a case takes fewer than B: at 4 rows
# each pod's 2 make ONE MoE token group across its two ranks (the
# reference's pods·data = 4 groups do not divide them)
ROWS = {"moe_span": 4}
# wave == off, bitwise: name -> (mode, selection backend)
WAVE_PARITY = {"hier2_xla": ("lags_hier2", "xla"),
               "hier2_kernel": ("lags_hier2", "kernel"),
               "hier_kernel": ("lags_hier", "kernel")}
WAVE_BYTES = 2048
EX_LEAVES = {"a": (100,), "b": (257,), "c": (50, 100)}
EX_BLOCK = 64

JAX_SCRIPT = """
import dataclasses, sys
import jax, numpy as np
from repro import api, compat
from repro.configs import base
from repro.launch import mesh as M, train as TR

inp = np.load(sys.argv[1])
mesh = M.make_host_mesh(data=WORLD // PODS, model=1, pod=PODS)
out = {}
for name, (mode, mc, pipeline, fixed, arch) in REF_MODES.items():
    cfg = dataclasses.replace(base.get_smoke_config(arch), **SMALL)
    run = api.RunConfig(mode=mode, momentum_correction=mc, donate=False,
                        pipeline=pipeline, wave_target_bytes=WAVE_BYTES,
                        **RUN_KW)
    step, _, meta = api.build_train_step(cfg, mesh, run)
    step = compile_once(step)
    state, _ = TR.init_state(cfg, mesh, method=mode, pipeline=pipeline,
                             momentum_correction=mc)
    flat, treedef = jax.tree.flatten(state["params"])
    state["params"] = jax.tree.unflatten(treedef, [
        jax.device_put(inp[f"{arch}/param{i}"], x.sharding)
        for i, x in enumerate(flat)])
    with compat.set_mesh(mesh):
        for t in range(STEPS):
            b = 0 if fixed else t
            rows = ROWS.get(name, B)
            batch = {"tokens": inp["tokens"][b][:rows],
                     "labels": inp["labels"][b][:rows]}
            state, metrics = step(state, batch)
            out[f"{name}/loss{t}"] = float(metrics["loss"])
    for part in ("params", "ef", "pending"):
        for i, x in enumerate(jax.tree.leaves(state.get(part, ()))):
            out[f"{name}/{part}{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(state.get("extra", {}))):
        out[f"{name}/mom{i}"] = np.asarray(x)
    out[f"{name}/n_waves"] = meta["waves"].n_waves if meta["waves"] else 0
np.savez(sys.argv[2], **out)
print("OK jax")
"""

RANK_SCRIPT = """
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
M.init_process_group(f"file://{store}", WORLD, rank, device="cpu")
flat_mesh = M.make_mesh(device="cpu")
mesh = M.make_mesh(pod=PODS, device="cpu")
assert mesh.mesh_dim_names == ("pod", "data")
assert M.inner_axis_names(mesh) == ("data",)
assert M.lags_axis_names(mesh, "lags_hier2") == ("pod",)
axes = M.worker_axes(mesh, M.data_axis_names(mesh))
assert axes.size == WORLD and dist.get_rank(axes.group) == rank
assert axes.sub(("pod",)).size == PODS and axes.sub(("data",)).size == 2
out = {}

# the distributed two-tier exchange on this rank's row of the updates
like = {k: np.zeros(s, np.float32) for k, s in EX_LEAVES.items()}
for backend in ("xla", "kernel"):
    ex = api.build_exchange(api.ExchangeSpec(
        mode="lags_hier2", params_like=like, ratio=20.0, ratio_inner=5.0,
        inner_compressor="topk_block", selection_backend=backend,
        block_size=EX_BLOCK, sim=False, n_workers=WORLD, n_inner=2))
    e = {t: {k: torch.from_numpy(inp[f"e0/{t}/{k}"][rank])
             for k in EX_LEAVES} for t in ("inner", "outer")}
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"][rank]) for k in EX_LEAVES}
        m, e = ex.exchange(u, e, axes)
        for k in EX_LEAVES:
            out[f"ex/{backend}/{t}/mean/{k}"] = m[k].numpy()
            for tier in ("inner", "outer"):
                out[f"ex/{backend}/{t}/{tier}/{k}"] = e[tier][k].numpy()

cfgs, starts = {}, {}
for arch in ARCHS:
    cfgs[arch] = dataclasses.replace(base.get_smoke_config(arch), **SMALL)
    leaves, treedef = tree.flatten(TT.abstract_params(cfgs[arch]))
    starts[arch] = tree.unflatten(treedef, [inp[f"{arch}/param{i}"]
                                            for i in range(len(leaves))])


def whole(x, p):
    # this rank's worker state x, (1, *chunk), as its whole leaf laid out
    # as the parameter p (lags_hier's FSDP blocks over 'data')
    if not D.is_dtensor(p):
        return x.detach().clone()
    return D.like_local(x[0].contiguous(), p).full_tensor()[None]


def at_rest(state):
    # (this rank's bytes of parameters and per-worker state, those of
    # the replicated layout: every leaf whole)
    ps = tree.leaves(state["params"])
    xs = (tree.leaves(state["ef"]) + tree.leaves(state.get("extra", {}))
          + tree.leaves(state.get("pending", ())))
    local = sum(D.local(x).numel() * x.element_size() for x in ps + xs)
    full = sum(p.numel() * p.element_size() for p in ps) + sum(
        4 * ps[i % len(ps)].numel() for i in range(len(xs)))
    return np.array([local, full])


def train(name, steps, fixed, save_after, on=None, arch="tinyllama_1_1b",
          **kw):
    cfg = cfgs[arch]
    run = api.RunConfig(wave_target_bytes=WAVE_BYTES, **RUN_KW, **kw)
    sess = api.Session(cfg, run, mesh=on or mesh)
    module = TT.from_jax_params(starts[arch], cfg, device="cpu")
    state, _ = sess.init_state(params=module.params)
    for t in range(steps):
        b, rows = 0 if fixed else t, ROWS.get(name, B)
        batch = {"tokens": torch.from_numpy(inp["tokens"][b][:rows]),
                 "labels": torch.from_numpy(inp["labels"][b][:rows])}
        state, metrics = sess.step_fn(state, batch)
        out[f"{name}/loss{t}"] = float(metrics["loss"])
        for p in tree.leaves(state["params"]):
            assert p.grad is None and not p._post_accumulate_grad_hooks
        if t + 1 == save_after:
            ps = tree.leaves(state["params"])
            for i, x in enumerate(tree.leaves(D.gather(state["params"]))):
                out[f"{name}/params{i}"] = x.clone().numpy()
            for part in ("ef", "pending"):
                for i, x in enumerate(tree.leaves(state.get(part, ()))):
                    out[f"{name}/{part}{i}"] = whole(
                        x, ps[i % len(ps)]).numpy()
            for i, x in enumerate(tree.leaves(state.get("extra", {}))):
                out[f"{name}/mom{i}"] = whole(x, ps[i]).numpy()
    out[f"rest/{name}"] = at_rest(state)
    out[f"fsdp/{name}"] = np.array([
        tuple(p.device_mesh.mesh_dim_names) == ("data",)
        for p in tree.leaves(state["params"]) if D.is_dtensor(p)])
    waves = sess.meta["waves"]
    out[f"{name}/n_waves"] = waves.n_waves if waves else 0
    out[f"{name}/n_workers"] = sess.meta["n_workers"]


for name, (mode, mc, pipeline, fixed, arch) in REF_MODES.items():
    # async1: a 4th step shows the honest staleness after the prefix
    train(name, STEPS + (pipeline == "async1"), fixed, STEPS, mode=mode,
          momentum_correction=mc, pipeline=pipeline, arch=arch,
          selection_backend="xla" if mode == "lags_hier2" else "kernel")
for name, (mode, backend) in WAVE_PARITY.items():
    for pipeline in ("off", "wave"):
        train(f"parity/{name}/{pipeline}", 2, False, 2, mode=mode,
              selection_backend=backend, pipeline=pipeline)
train("async1", STEPS + 1, True, STEPS, mode="lags_hier2",
      selection_backend="kernel", pipeline="async1")
train("async1_off", STEPS, True, STEPS, mode="lags_hier2",
      selection_backend="kernel")
train("dp_pod", STEPS, False, STEPS, mode="lags_dp",
      selection_backend="kernel")
train("dp_flat", STEPS, False, STEPS, on=flat_mesh, mode="lags_dp",
      selection_backend="kernel")
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""


def _constants() -> str:
    return "".join(f"{name} = {globals()[name]!r}\n" for name in (
        "WORLD", "PODS", "STEPS", "B", "ROWS", "SMALL", "ARCHS", "RUN_KW",
        "REF_MODES",
        "WAVE_PARITY", "WAVE_BYTES", "EX_LEAVES", "EX_BLOCK"))


def _exchange_inputs(rng):
    """Stacked (WORLD, ...) updates of two steps and start residuals of
    both tiers, the outer one the same on both ranks of a pod."""
    out = {}
    for k, s in EX_LEAVES.items():
        out[f"e0/inner/{k}"] = (0.05 * rng.standard_normal(
            (WORLD,) + s)).astype(np.float32)
        pods = (0.05 * rng.standard_normal((PODS,) + s)).astype(np.float32)
        out[f"e0/outer/{k}"] = np.repeat(pods, WORLD // PODS, axis=0)
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
    tmp = tmp_path_factory.mktemp("hier")
    inp = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(base.get_smoke_config(arch), **SMALL)
        params, _ = JT.init_model(jax.random.PRNGKey(0), cfg)
        inp.update({f"{arch}/param{i}": np.asarray(p)
                    for i, p in enumerate(jax.tree.leaves(params))})
    rng = np.random.default_rng(14)
    toks = rng.integers(0, SMALL["vocab"], (STEPS, B, S + 1)).astype(
        np.int32)
    inp.update(tokens=toks[..., :-1], labels=toks[..., 1:],
               **_exchange_inputs(rng))
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


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_hier2_distributed_matches_sim_bitwise(runs, backend):
    inp, ranks = runs[0], runs[2]
    like = {k: torch.zeros(s) for k, s in EX_LEAVES.items()}
    ex = TR.build_exchange(TR.ExchangeSpec(
        mode="lags_hier2", params_like=like, ratio=20.0, ratio_inner=5.0,
        inner_compressor="topk_block", selection_backend=backend,
        block_size=EX_BLOCK, sim=True, n_workers=WORLD, n_inner=2))
    e = {t: {k: torch.from_numpy(inp[f"e0/{t}/{k}"]) for k in EX_LEAVES}
         for t in ("inner", "outer")}
    for t in range(2):
        u = {k: torch.from_numpy(inp[f"u{t}/{k}"]) for k in EX_LEAVES}
        m, e = ex.exchange(u, e, None)
        for r, res in enumerate(ranks):
            for k in EX_LEAVES:
                tag = f"ex/{backend}/{t}"
                np.testing.assert_array_equal(
                    _bits(res[f"{tag}/mean/{k}"]), _bits(m[k].numpy()),
                    err_msg=f"mean {k} rank {r} step {t}")
                for tier in ("inner", "outer"):
                    np.testing.assert_array_equal(
                        _bits(res[f"{tag}/{tier}/{k}"]),
                        _bits(e[tier][k][r].numpy()),
                        err_msg=f"{tier} {k} rank {r} step {t}")
    assert all(np.abs(ranks[0][f"ex/{backend}/1/{tier}/{k}"]).sum() > 0
               for tier in ("inner", "outer") for k in EX_LEAVES)


@pytest.mark.parametrize("name", list(REF_MODES))
def test_three_steps_match_jax_build_train_step(runs, name):
    """Losses rtol 1e-5; parameters, residuals (both tiers), velocities
    and pending updates rtol 1e-4 atol 1e-5; parameters equal on every
    rank.  The reference's per-worker state has one row per worker: per
    rank for lags_hier2, per pod for lags_hier."""
    _, jres, ranks = runs
    got = ranks[0]
    mode, mc, pipeline, _, _ = REF_MODES[name]
    np.testing.assert_allclose(
        [got[f"{name}/loss{t}"] for t in range(STEPS)],
        [jres[f"{name}/loss{t}"] for t in range(STEPS)], rtol=1e-5)
    assert got[f"{name}/n_waves"] == jres[f"{name}/n_waves"]
    assert got[f"{name}/n_workers"] == (PODS if mode == "lags_hier"
                                        else WORLD)
    n = len([k for k in jres if k.startswith(f"{name}/params")])
    assert n >= 12
    for i in range(n):
        key = f"{name}/params{i}"
        np.testing.assert_allclose(got[key], jres[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[key], got[key], err_msg=key)
    per_pod = mode == "lags_hier"
    for part, want in (("ef", 2 * n if mode == "lags_hier2" else n),
                       ("mom", n if mc else 0),
                       ("pending", n if pipeline == "async1" else 0)):
        keys = [k for k in jres if k.startswith(f"{name}/{part}")]
        assert len(keys) == want, (part, keys)
        assert len([k for k in got if k.startswith(f"{name}/{part}")]) \
            == want
        for key in keys:
            for r, res in enumerate(ranks):
                row = r // (WORLD // PODS) if per_pod else r
                np.testing.assert_allclose(res[key][0], jres[key][row],
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{key} rank {r}")


def _bitwise_equal(res: dict, prefix_a: str, prefix_b: str,
                   what: str) -> int:
    def keys(prefix):
        return sorted(k[len(prefix):] for k in res if k.startswith(prefix)
                      and k[len(prefix):] not in ("n_waves", "n_workers"))
    assert keys(prefix_a) == keys(prefix_b), what
    for k in keys(prefix_a):
        np.testing.assert_array_equal(_bits(res[prefix_a + k]),
                                      _bits(res[prefix_b + k]),
                                      err_msg=f"{what} {k}")
    return len(keys(prefix_a))


@pytest.mark.parametrize("name", list(WAVE_PARITY))
def test_wave_equals_off_bitwise_on_the_pod_mesh(runs, name):
    """Losses, parameters and every tier's residuals of 2 steps: ``wave``
    == ``off`` bit for bit on every rank, with several waves."""
    ranks = runs[2]
    mode = WAVE_PARITY[name][0]
    for r, res in enumerate(ranks):
        assert res[f"parity/{name}/wave/n_waves"] > 1
        count = _bitwise_equal(res, f"parity/{name}/off/",
                               f"parity/{name}/wave/", f"{name} rank {r}")
        assert count == 2 + 12 + (24 if mode == "lags_hier2" else 12)


def test_async1_reproduces_the_exact_sync_prefix(runs):
    ranks = runs[2]
    for res in ranks:
        a = [res[f"async1/loss{t}"] for t in range(STEPS + 1)]
        off = [res[f"async1_off/loss{t}"] for t in range(STEPS)]
        assert all(np.isfinite(a))
        assert a[0] == off[0] and a[1] == off[0]
        assert a[2] == off[1]
        assert a[3] != off[2]
        assert len([k for k in res if k.startswith("async1/pending")]) == 12


def test_lags_dp_on_the_pod_mesh_equals_the_flat_mesh(runs):
    ranks = runs[2]
    for r, res in enumerate(ranks):
        assert res["dp_pod/n_workers"] == res["dp_flat/n_workers"] == WORLD
        assert _bitwise_equal(res, "dp_pod/", "dp_flat/",
                              f"rank {r}") == STEPS + 24


@pytest.mark.parametrize("name", ["hier", "hier_async1_mc", "moe_hier",
                                  "moe_span"])
def test_lags_hier_holds_its_parameters_over_data(runs, name):
    """On the data-only pod mesh ``lags_hier``'s parameters are
    ``DTensor``s on each pod's 'data' sub-mesh (FSDP, the reference's
    layout) and its residuals, velocities and pending updates their
    blocks: a card holds ``REST_BAND`` of the replicated layout's bytes
    at rest (half, and the leaves that no dim of which splits over
    'data' whole); ``lags_hier2`` keeps every leaf whole."""
    for res in runs[2]:
        n = len([k for k in res if k.startswith(f"{name}/params")])
        fsdp = res[f"fsdp/{name}"]
        assert len(fsdp) == n >= 12 and fsdp.all()
        local, full = res[f"rest/{name}"]
        assert REST_BAND[0] <= local / full <= REST_BAND[1], local / full
        local, full = res["rest/hier2"]
        assert local == full and len(res["fsdp/hier2"]) == 0
