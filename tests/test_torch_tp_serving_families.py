"""Serving every family over ("data", "model") against the reference:
the xLSTM and Mamba decode states, the cross caches and a VLM's patches
on 'model', and FSDP serving.

Four gloo ranks at ``make_mesh(model=2)`` (data 2 × model 2) run
``launch/serve``'s prefill and decode steps on each case's smoke config
in f32: xLSTM (mLSTM and sLSTM states), the paper's LSTM (sLSTM states),
Jamba (Mamba states, the MoE layer and attention together),
SeamlessM4T with 16 encoder frames (its cross caches split over 'model')
and with 15 (whole on every 'model' rank), LLaVA with 8 patches ahead
of its prompt, and TinyLlama.  The reference's one-device
``serving.engine`` runs the same prompts in this process (GSPMD
computes the same function on one device).  TinyLlama and Jamba are
served again with ``launch.serve.DEVICE_BYTES`` set low, so that
``needs_fsdp_serving`` holds and the parameters rest over ('data',
'model').  A gloo world of one serves at ("data", "model") = 1 × 1
beside the one-device path, in bf16.

Contracts:
  * prefill's logits and 4 greedy decode steps' logits within rtol and
    atol 1e-5 of the reference's on every rank, and the same tokens;
    ``ServeSession(mesh=).generate`` returns the reference's tokens;
  * the decode states laid out as ``launch.serve.place_states``
    documents: each rank its rows of the batch; attention caches (self
    and cross) split on their slots when their number divides by 2,
    else whole; Mamba's states on ``d_inner``; the xLSTM states on
    their heads;
  * FSDP serving gives its tensor-parallel twin's logits bit for bit,
    and each rank's bytes at rest are its ('data', 'model') chunks:
    a quarter of the whole but for the small leaves the rules leave
    whole over 'data';
  * two planted faults leave the tolerance: the recurrent layers'
    sums over 'model' skipped (``models.tp.all_sum``: Mamba's
    ``x_proj`` partials, the mLSTM norm's mean square) and the cross
    caches' log-sum-exp combine skipped;
  * at 1 × 1 the logits are the one-device path's, bit for bit.
"""
import dataclasses
import math
import os
import textwrap

import numpy as np
import pytest
from test_torch_spawn import Lazy, Spawned, load

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN, CHUNK, TOL = 4, 8, 1e-5
F32 = dict(dtype="float32", param_dtype="float32")
# case -> (arch, batch, prompt tokens, frontend rows: encoder frames or
# patches)
CASES = {"xlstm": ("xlstm_1_3b", 4, 20, 0),
         "lstm": ("paper_lstm_ptb", 4, 20, 0),
         "jamba": ("jamba_v0_1_52b", 4, 20, 0),
         "seamless": ("seamless_m4t_large_v2", 4, 12, 16),
         "seamless_odd": ("seamless_m4t_large_v2", 4, 12, 15),
         "llava": ("llava_next_mistral_7b", 4, 12, 8),
         "tinyllama": ("tinyllama_1_1b", 4, 20, 0)}
ARCHS = sorted({a for a, _, _, _ in CASES.values()})
# the cases served again under FSDP (each its own tensor-parallel twin)
FSDP = ("tinyllama", "jamba")
# the cases ServeSession.generate serves
GENERATE = ("xlstm", "jamba")
# planted fault -> the cases it runs on
FAULTS = {"state_sum": ("jamba", "xlstm"), "cross_combine": ("seamless",)}
# the world of one: the cases held bitwise at 1 x 1 (in bf16)
ONE = ("xlstm", "jamba", "seamless", "llava")

RANK_SCRIPT = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import mesh as M, serve as SV
from repro_torch.models import attention as A, tp as TP, transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.sharding import dtensor as D
from repro_torch.stream import subscriber as SS

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", 4, rank, device="cpu")
mesh = M.make_mesh(model=2, device="cpu")
out = {}


def params_of(arch, cfg):
    leaves, treedef = tree.flatten(TT.abstract_params(cfg))
    start = tree.unflatten(treedef, [inp[f"{arch}/param{i}"]
                                     for i in range(len(leaves))])
    return TT.from_jax_params(start, cfg, device="cpu").params


def serve(key, name, cfg, params, layout=False):
    arch, b, n, nf = CASES[name]
    batch = {"tokens": torch.from_numpy(inp[f"{name}/prompts"])}
    if nf:
        batch["frontend_embeds"] = torch.from_numpy(inp[f"{name}/front"])
    plen = n + (nf if cfg.frontend == "vision" else 0)
    cap = plen + GEN
    shape = base.InputShape("serve", n, b, "prefill")
    prefill, _ = SV.make_prefill_step(cfg, mesh, shape, chunk=CHUNK)
    step, _ = SV.make_serve_step(cfg, mesh, dataclasses.replace(
        shape, seq_len=cap, kind="decode"), chunk=CHUNK)
    placed = SV.place_params(cfg, mesh, params)
    out[f"{key}/bytes"] = np.array(sum(
        D.local(p).numel() * p.element_size() for p in tree.leaves(placed)))
    logits, states = prefill(placed, batch)
    states = TE.pad_states_for_decode(cfg, states, plen, cap)
    out[f"{key}/logits0"] = logits.numpy()
    tok = torch.argmax(logits, -1)[:, None]
    toks = []
    for i in range(GEN):
        toks.append(tok)
        logits, states = step(placed, tok, states, plen + i)
        out[f"{key}/logits{i + 1}"] = logits.numpy()
        tok = torch.argmax(logits, -1)[:, None]
    out[f"{key}/tokens"] = torch.cat(toks, 1).numpy()
    if layout:
        for path, x in zip(tree.leaf_paths(states), tree.leaves(states)):
            out[f"{key}/state/{path}/global"] = np.array(x.shape)
            out[f"{key}/state/{path}/local"] = np.array(D.local(x).shape)


for name, (arch, b, n, nf) in CASES.items():
    cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
    params = params_of(arch, cfg)
    serve(name, name, cfg, params, layout=True)
    if name in GENERATE:
        sess = SS.ServeSession(cfg, base.InputShape("serve", n, b, "decode"),
                               params, mesh=mesh, chunk=CHUNK)
        out[f"{name}/generate"] = sess.generate(
            torch.from_numpy(inp[f"{name}/prompts"]), GEN).numpy()
    if name in FSDP:
        real = SV.DEVICE_BYTES
        SV.DEVICE_BYTES = 1024
        try:
            out[f"fsdp/{name}/on"] = np.array(SV.fsdp(cfg, mesh))
            serve(f"fsdp/{name}", name, cfg, params)
        finally:
            SV.DEVICE_BYTES = real
    for fault, names in FAULTS.items():
        if name not in names:
            continue
        if fault == "state_sum":
            mod, attr, fake = TP, "all_sum", lambda x, mesh: x
        else:
            mod, attr, fake = A, "_lse_combine", lambda m, l, acc, g: (l, acc)
        real = getattr(mod, attr)
        setattr(mod, attr, fake)
        try:
            serve(f"{fault}/{name}", name, cfg, params)
        finally:
            setattr(mod, attr, real)
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""

ONE_RANK = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import mesh as M, serve as SV
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.sharding import dtensor as D

store, out_path = sys.argv[1], sys.argv[2]
M.init_process_group(f"file://{store}", 1, 0, device="cpu")
mesh = M.make_mesh(model=1, device="cpu")
out = {}
for name in ONE:
    arch, b, n, nf = CASES[name]
    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = TT.Transformer(cfg, seed=0, device="cpu").params
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, n)))}
    if nf:
        batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, nf, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    plen = n + (nf if cfg.frontend == "vision" else 0)
    shape = base.InputShape("serve", n, 2, "prefill")
    for key, m in (("none", None), ("1x1", mesh)):
        prefill, _ = SV.make_prefill_step(cfg, m, shape, chunk=CHUNK)
        step, _ = SV.make_serve_step(cfg, m, dataclasses.replace(
            shape, seq_len=plen + GEN, kind="decode"), chunk=CHUNK)
        placed = SV.place_params(cfg, m, params)
        out[f"{name}/{key}/dtensor"] = np.array(all(
            D.is_dtensor(p) for p in tree.leaves(placed)))
        logits, states = prefill(placed, batch)
        states = TE.pad_states_for_decode(cfg, states, plen, plen + GEN)
        out[f"{name}/{key}/logits0"] = logits.float().numpy()
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(GEN):
            logits, states = step(placed, tok, states, plen + i)
            out[f"{name}/{key}/logits{i + 1}"] = logits.float().numpy()
            tok = torch.argmax(logits, -1)[:, None]
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK one rank")
"""


def _constants() -> str:
    names = ("GEN", "CHUNK", "F32", "CASES", "FSDP", "GENERATE", "FAULTS",
             "ONE")
    return "".join(f"{n} = {globals()[n]!r}\n" for n in names)


def _inputs() -> dict:
    """The reference's init of each model (f32), each case's prompts and
    frontend rows (numpy, from a seed)."""
    from repro.configs import base
    from repro.models import transformer as JT
    inp = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
        params = jax.jit(lambda k: JT.init_model(k, cfg)[0])(
            jax.random.PRNGKey(0))
        for i, p in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param{i}"] = np.asarray(p)
    rng = np.random.default_rng(30)
    for name, (arch, b, n, nf) in CASES.items():
        inp[f"{name}/prompts"] = rng.integers(0, 512, (b, n)).astype(
            np.int64)
        if nf:
            inp[f"{name}/front"] = rng.standard_normal(
                (b, nf, 128)).astype(np.float32)
    return inp


def _reference(inp: dict) -> dict:
    """The reference's one-device engine on each case: prefill's logits,
    then GEN greedy decode steps' logits, and the greedy tokens."""
    import jax.numpy as jnp
    from repro.configs import base
    from repro.models import transformer as JT
    from repro.serving import engine as JE
    out = {}
    for name, (arch, b, n, nf) in CASES.items():
        cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
        like = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                    cfg)[0])
        leaves, treedef = jax.tree.flatten(like)
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(inp[f"{arch}/param{i}"]) for i in range(len(leaves))])
        prompts = jnp.asarray(inp[f"{name}/prompts"].astype(np.int32))
        front = jnp.asarray(inp[f"{name}/front"]) if nf else None
        plen = n + (nf if cfg.frontend == "vision" else 0)
        logits, states = jax.jit(lambda p, t, f: JE.prefill(
            p, cfg, t, frontend_embeds=f, chunk=CHUNK))(params, prompts,
                                                        front)
        states = JE.pad_states_for_decode(cfg, states, plen, plen + GEN)
        step = jax.jit(lambda p, t, s, pos: JE.serve_step(
            p, cfg, t, s, pos, chunk=CHUNK))
        out[f"{name}/logits0"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks = []
        for i in range(GEN):
            toks.append(np.asarray(tok))
            logits, states = step(params, tok, states, jnp.int32(plen + i))
            out[f"{name}/logits{i + 1}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out[f"{name}/tokens"] = np.concatenate(toks, 1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four gloo ranks and the world of one, started together
    (``test_torch_spawn.Spawned``); the reference runs in this process
    meanwhile.  Results by index, each computed when first read: (the
    reference's, the ranks', the world of one's)."""
    tmp = tmp_path_factory.mktemp("tp_serving_families")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    sp = Spawned(tmp, dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                           OMP_NUM_THREADS="1"))
    for r in range(4):
        sp.start(f"rank{r}", _constants() + textwrap.dedent(RANK_SCRIPT),
                 [r, tmp / "store4", tmp / "in.npz", tmp / f"rank{r}.npz"])
    sp.start("one_rank", _constants() + textwrap.dedent(ONE_RANK),
             [tmp / "store1", tmp / "one.npz"])

    def ranks():
        sp.wait(*(f"rank{r}" for r in range(4)))
        return [load(tmp / f"rank{r}.npz") for r in range(4)]

    def one():
        sp.wait("one_rank")
        return load(tmp / "one.npz")
    try:
        yield Lazy(lambda: _reference(inp), ranks, one)
    finally:
        sp.close()


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_tokens_match_the_reference(runs, case):
    """Prefill and GEN greedy decode steps on data 2 × model 2: every
    rank's global logits within rtol and atol 1e-5 of the reference's
    one-device engine, and the same greedy tokens."""
    ref, ranks = runs[0], runs[1]
    for r, res in enumerate(ranks):
        for i in range(GEN + 1):
            np.testing.assert_allclose(
                res[f"{case}/logits{i}"], ref[f"{case}/logits{i}"],
                rtol=TOL, atol=TOL, err_msg=f"{case} step {i} rank {r}")
        np.testing.assert_array_equal(res[f"{case}/tokens"],
                                      ref[f"{case}/tokens"])


@pytest.mark.parametrize("case", GENERATE)
def test_generate_returns_the_reference_tokens(runs, case):
    """``ServeSession(mesh=).generate`` on the recurrent states: the
    reference's greedy tokens, on every rank."""
    ref, ranks = runs[0], runs[1]
    for res in ranks:
        np.testing.assert_array_equal(res[f"{case}/generate"],
                                      ref[f"{case}/tokens"])


def _want_local(path: str, glob) -> list:
    """The local shape ``place_states`` documents for the state leaf at
    ``path`` whose ``DTensor`` over 'model' has the shape ``glob`` (this
    rank's rows)."""
    want = list(glob)
    at = 1 if path.startswith("blocks/") else 0
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("k", "v"):
        if want[at + 1] % 2 == 0:                     # the slots
            want[at + 1] //= 2
    elif leaf == "conv":
        want[-1] //= 2                                # d_inner
    elif leaf == "ssm":
        want[at + 1] //= 2                            # d_inner
    else:
        want[at + 1] //= 2                            # an xLSTM state's heads
    return want


@pytest.mark.parametrize("case", list(CASES))
def test_states_are_laid_out_as_place_states_documents(runs, case):
    """Every decode state leaf after the last step: this rank's rows;
    attention caches split on their slots where they divide (the
    seamless_odd case's 15 cross slots do not), Mamba's states on
    ``d_inner``, the xLSTM states on their heads."""
    res = runs[1][0]
    pre = f"{case}/state/"
    paths = sorted({k[len(pre):].rsplit("/", 1)[0] for k in res
                    if k.startswith(pre)})
    assert paths
    kinds = set()
    for path in paths:
        glob = res[f"{pre}{path}/global"]
        kinds.add(path.rsplit("/", 1)[-1])
        # the batch of 4 over 'data' 2
        assert glob[1 if path.startswith("blocks/") else 0] == 2, path
        assert list(res[f"{pre}{path}/local"]) == _want_local(
            path, glob), (path, glob)
    if case.startswith("seamless"):
        cross = [p for p in paths if "/cross/" in p]
        glob = res[f"{pre}{cross[0]}/global"]
        loc = res[f"{pre}{cross[0]}/local"]
        assert glob[2] == CASES[case][3]
        assert loc[2] == (glob[2] if case == "seamless_odd" else glob[2] // 2)
    if case == "jamba":
        assert {"conv", "ssm", "k", "v"} <= kinds


@pytest.mark.parametrize("case", FSDP)
def test_fsdp_serving_is_bitwise_its_tensor_parallel_twin(runs, case):
    """With ``needs_fsdp_serving`` (``DEVICE_BYTES`` set low) the steps
    shard the parameters over 'data' too and gather each layer before it
    runs: every logit the 'model'-only layout's, bit for bit."""
    for res in runs[1]:
        assert bool(res[f"fsdp/{case}/on"])
        for i in range(GEN + 1):
            np.testing.assert_array_equal(
                _bits(res[f"fsdp/{case}/logits{i}"]),
                _bits(res[f"{case}/logits{i}"]), err_msg=f"step {i}")
        np.testing.assert_array_equal(res[f"fsdp/{case}/tokens"],
                                      res[f"{case}/tokens"])


@pytest.mark.parametrize("case", FSDP)
def test_fsdp_bytes_at_rest_are_the_data_model_chunks(runs, case):
    """Each rank's bytes at rest under FSDP: the sum of its ('data',
    'model') chunks by the rules' specs, within 5 % of a quarter of the
    whole (the rules leave a few small leaves whole over 'data': norms'
    and Mamba's per-channel vectors), and about half the twin's."""
    from repro_torch import tree
    from repro_torch.configs import base
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import dtensor as D
    import types
    cfg = dataclasses.replace(base.get_smoke_config(CASES[case][0]), **F32)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: 2)
    real = SV.DEVICE_BYTES
    SV.DEVICE_BYTES = 1024
    try:
        specs = SV.serve_param_specs(cfg, mesh)
    finally:
        SV.DEVICE_BYTES = real
    like = TT.abstract_params(cfg)
    whole = sum(p.numel() * 4 for p in tree.leaves(like))
    chunks = sum(4 * math.prod(D.local_shape(p.shape, s,
                                             {"data": 2, "model": 2}))
                 for p, s in zip(tree.leaves(like), tree.flatten_up_to(
                     tree.flatten(like)[1], specs)))
    assert whole / 4 <= chunks <= 1.05 * whole / 4
    for res in runs[1]:
        got, twin = int(res[f"fsdp/{case}/bytes"]), int(res[f"{case}/bytes"])
        assert got == chunks
        assert got <= 0.55 * twin


@pytest.mark.parametrize("fault,case", [(f, c) for f, cs in FAULTS.items()
                                        for c in cs])
def test_planted_faults_leave_the_tolerance(runs, fault, case):
    """``state_sum``: the recurrent layers' partial sums over 'model'
    left unsummed; ``cross_combine``: each rank normalising its own cross
    slots.  The decode logits leave the tolerance the sound steps meet;
    the cross fault's prefill stays in it (prefill attends whole
    caches)."""
    ref = runs[0]
    for res in runs[1]:
        assert not np.allclose(res[f"{fault}/{case}/logits1"],
                               ref[f"{case}/logits1"], rtol=TOL, atol=TOL)
        if fault == "cross_combine":
            np.testing.assert_allclose(res[f"{fault}/{case}/logits0"],
                                       ref[f"{case}/logits0"], rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("case", ONE)
def test_one_by_one_mesh_is_bitwise_the_one_device_path(runs, case):
    """On a gloo world of one, serving at ("data", "model") = 1 × 1 in
    bf16 (the parameters and states ``DTensor``s over one rank) gives
    the one-device path's logits, bit for bit."""
    res = runs[2]
    assert not bool(res[f"{case}/none/dtensor"])
    assert bool(res[f"{case}/1x1/dtensor"])
    for i in range(GEN + 1):
        np.testing.assert_array_equal(
            _bits(res[f"{case}/1x1/logits{i}"]),
            _bits(res[f"{case}/none/logits{i}"]), err_msg=f"step {i}")
