"""Serving the dense and MoE decoders over ("data", "model") against the
reference, and a ``ServeSession``'s packets and resyncs there.

Four gloo ranks at ``make_mesh(model=2)`` (data 2 × model 2) run
``launch/serve``'s prefill and decode steps and
``stream/subscriber.ServeSession(mesh=).generate`` on each case's smoke
config in f32: TinyLlama (full caches), OLMoE (the MoE layer's E
layout), Granite (its F layout), Gemma3 (window-16 rings beside full
caches, the 20-token prompt past the window) and TinyLlama again at a
batch of 3 and a capacity of 23 (neither divides by 2: every data rank
serves every row, and every 'model' rank holds every slot).  The
reference's one-device ``serving.engine`` runs the same prompts in this
process (GSPMD computes the same function on one device).  A gloo world
of one serves at ("data", "model") = 1 × 1 beside the one-device path.

Contracts:
  * prefill's logits and 4 greedy decode steps' logits within rtol and
    atol 1e-5 of the reference's on every rank, and the same tokens;
    ``generate`` returns the reference's greedy tokens on every rank;
  * the caches are laid out batch over 'data' and sequence over 'model'
    where the sizes divide (each rank its rows and its chunk of the
    slots), else whole;
  * the decode step with the log-sum-exp combine over 'model' skipped
    (``attention._lse_combine`` replaced: each rank normalises its own
    slots) leaves the tolerance;
  * a ``ServeSession`` over 'model' follows a weight stream (a full
    packet, then deltas of a ``StreamPublisher``): after each packet its
    gathered parameters are a one-device session's, bit for bit; a
    dropped version is refused (``gap``); ``resync`` from ``save_full``
    restores them bit for bit; and ``generate`` then gives the one-device
    session's tokens;
  * at 1 × 1 the logits and tokens are the one-device path's, bit for
    bit;
  * ``check_mesh`` admits every family on a 'model' axis, and FSDP
    serving (Nemotron-4-340B), and refuses an xLSTM whose heads do not
    split over it.
"""
import dataclasses
import os
import textwrap
import types

import numpy as np
import pytest
from test_torch_spawn import Lazy, Spawned, load

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN, CHUNK, TOL = 4, 8, 1e-5
F32 = dict(dtype="float32", param_dtype="float32")
# case -> (arch, batch, prompt length)
CASES = {"tinyllama": ("tinyllama_1_1b", 4, 20),
         "olmoe": ("olmoe_1b_7b", 4, 20),
         "granite": ("granite_moe_3b_a800m", 4, 20),
         "gemma3": ("gemma3_27b", 4, 20),
         "odd": ("tinyllama_1_1b", 3, 19)}
ARCHS = sorted({a for a, _, _ in CASES.values()})
# the case the planted fault and the weight stream run on
FAULT = "tinyllama"
# the packets the stream offers before the dropped one: a full, deltas
STREAM_PACKETS = 3
# the world of one: the archs held bitwise at 1 x 1
ONE_ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b")

RANK_SCRIPT = """
import dataclasses, os, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.launch import mesh as M, serve as SV
from repro_torch.models import attention as A, transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.sharding import dtensor as D
from repro_torch.stream import StreamPublisher
from repro_torch.stream import subscriber as SS

rank, store, inp_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4])
inp = np.load(inp_path)
M.init_process_group(f"file://{store}", 4, rank, device="cpu")
mesh = M.make_mesh(model=2, device="cpu")
coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
out = {"coord": np.array([coord["data"], coord["model"]])}


def params_of(arch, cfg):
    leaves, treedef = tree.flatten(TT.abstract_params(cfg))
    start = tree.unflatten(treedef, [inp[f"{arch}/param{i}"]
                                     for i in range(len(leaves))])
    return TT.from_jax_params(start, cfg, device="cpu").params


def serve(key, cfg, params, prompts):
    b, n = prompts.shape
    cap = n + GEN
    shape = base.InputShape("serve", n, b, "prefill")
    prefill, _ = SV.make_prefill_step(cfg, mesh, shape, chunk=CHUNK)
    step, _ = SV.make_serve_step(cfg, mesh, dataclasses.replace(
        shape, seq_len=cap, kind="decode"), chunk=CHUNK)
    placed = SV.place_params(cfg, mesh, params)
    logits, states = prefill(placed, {"tokens": prompts})
    states = TE.pad_states_for_decode(cfg, states, n, cap)
    out[f"{key}/logits0"] = logits.numpy()
    tok = torch.argmax(logits, -1)[:, None]
    toks = []
    for i in range(GEN):
        toks.append(tok)
        logits, states = step(placed, tok, states, n + i)
        out[f"{key}/logits{i + 1}"] = logits.numpy()
        if i == 0:
            kv = tree.leaves(states)[0]
            out[f"{key}/cache_local"] = np.array(D.local(kv).shape)
            out[f"{key}/cache_global"] = np.array(kv.shape)
        tok = torch.argmax(logits, -1)[:, None]
    out[f"{key}/tokens"] = torch.cat(toks, 1).numpy()


def same(sess, one):
    # whether sess's gathered parameters are one's, bitwise
    return all(torch.equal(a, b) for a, b in zip(
        tree.leaves(D.gather(sess.params)), tree.leaves(one.params)))


def stream(cfg, params, prompts, sess, one):
    # a weight stream offered to the session over 'model' and to a
    # one-device one: a full packet, then sparse deltas of the weights
    # moved by seeded noise; a dropped version; a resync
    pub = StreamPublisher(params, every=1, budget_bytes=8192)
    now = tree.map(lambda p: p.clone(), params)
    gen = torch.Generator().manual_seed(3)

    def publish(step):
        for p in tree.leaves(now):
            p.add_(1e-2 * torch.randn(p.shape, generator=gen))
        return pub.publish(step, now)

    for step in range(STREAM_PACKETS):
        pkt = publish(step)
        statuses = (sess.apply_packet(pkt), one.apply_packet(pkt))
        out[f"stream/{step}/status"] = np.array(statuses)
        out[f"stream/{step}/kind"] = np.array(pkt.kind)
        out[f"stream/{step}/same"] = np.array(same(sess, one))
    publish(STREAM_PACKETS)
    pkt = publish(STREAM_PACKETS + 1)
    out["stream/gap"] = np.array((sess.apply_packet(pkt),
                                  one.apply_packet(pkt)))
    out["stream/needs_resync"] = np.array(sess.needs_resync)
    path = pub.save_full(os.path.join(os.path.dirname(out_path),
                                      f"resync{rank}"), step=9)
    out["stream/resync"] = np.array((sess.resync(path), one.resync(path),
                                     pub.version))
    out["stream/resync_same"] = np.array(same(sess, one))
    out["stream/resync_full"] = np.array(all(torch.equal(
        a, b) for a, b in zip(tree.leaves(one.params),
                              tree.leaves(pub.published))))
    out["stream/generate"] = sess.generate(prompts, GEN).numpy()
    out["stream/generate_one"] = one.generate(prompts, GEN).numpy()


for name, (arch, b, n) in CASES.items():
    cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
    params = params_of(arch, cfg)
    prompts = torch.from_numpy(inp[f"{name}/prompts"])
    serve(name, cfg, params, prompts)
    sess = SS.ServeSession(cfg, base.InputShape("serve", n, b, "decode"),
                           params, mesh=mesh, chunk=CHUNK)
    out[f"{name}/generate"] = sess.generate(prompts, GEN).numpy()
    if name == FAULT:
        # each session its own copy: they apply packets in place
        stream(cfg, params, prompts, *(SS.ServeSession(
            cfg, base.InputShape("serve", n, b, "decode"),
            tree.map(lambda p: p.clone(), params), mesh=m, chunk=CHUNK)
            for m in (mesh, None)))
        real = A._lse_combine
        A._lse_combine = lambda m, l, acc, group: (l, acc)
        try:
            serve(name + "/fault", cfg, params, prompts)
        finally:
            A._lse_combine = real
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK rank", rank)
"""

ONE_RANK = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import base
from repro_torch.launch import mesh as M, serve as SV
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.sharding import dtensor as D
from repro_torch import tree
from repro_torch.stream import subscriber as SS

store, out_path = sys.argv[1], sys.argv[2]
M.init_process_group(f"file://{store}", 1, 0, device="cpu")
mesh = M.make_mesh(model=1, device="cpu")
out = {}
for arch in ONE_ARCHS:
    cfg = base.get_smoke_config(arch)
    params = TT.Transformer(cfg, seed=0, device="cpu").params
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 12)))
    shape = base.InputShape("serve", 12, 2, "prefill")
    for name, m in (("none", None), ("1x1", mesh)):
        prefill, _ = SV.make_prefill_step(cfg, m, shape, chunk=CHUNK)
        step, _ = SV.make_serve_step(cfg, m, dataclasses.replace(
            shape, seq_len=12 + GEN, kind="decode"), chunk=CHUNK)
        placed = SV.place_params(cfg, m, params)
        out[f"{arch}/{name}/dtensor"] = np.array(all(
            D.is_dtensor(p) for p in tree.leaves(placed)))
        logits, states = prefill(placed, {"tokens": prompts})
        states = TE.pad_states_for_decode(cfg, states, 12, 12 + GEN)
        out[f"{arch}/{name}/logits0"] = logits.float().numpy()
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(GEN):
            logits, states = step(placed, tok, states, 12 + i)
            out[f"{arch}/{name}/logits{i + 1}"] = logits.float().numpy()
            tok = torch.argmax(logits, -1)[:, None]
        sess = SS.ServeSession(cfg, dataclasses.replace(shape, kind="decode"),
                               params, mesh=m, chunk=CHUNK)
        out[f"{arch}/{name}/generate"] = sess.generate(prompts, GEN).numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
print("OK one rank")
"""


def _constants() -> str:
    names = ("GEN", "CHUNK", "F32", "CASES", "FAULT", "STREAM_PACKETS",
             "ONE_ARCHS")
    return "".join(f"{n} = {globals()[n]!r}\n" for n in names)


def _inputs() -> dict:
    """The reference's init of each model (f32) and each case's prompts
    (numpy, from a seed)."""
    from repro.configs import base
    from repro.models import transformer as JT
    inp = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
        params = jax.jit(lambda k: JT.init_model(k, cfg)[0])(
            jax.random.PRNGKey(0))
        for i, p in enumerate(jax.tree.leaves(params)):
            inp[f"{arch}/param{i}"] = np.asarray(p)
    rng = np.random.default_rng(29)
    for name, (arch, b, n) in CASES.items():
        inp[f"{name}/prompts"] = rng.integers(0, 512, (b, n)).astype(
            np.int64)
    return inp


def _reference(inp: dict) -> dict:
    """The reference's one-device engine on each case: prefill's logits,
    then GEN greedy decode steps' logits, and the greedy tokens."""
    import jax.numpy as jnp
    from repro.configs import base
    from repro.models import transformer as JT
    from repro.serving import engine as JE
    out = {}
    for name, (arch, b, n) in CASES.items():
        cfg = dataclasses.replace(base.get_smoke_config(arch), **F32)
        like = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                    cfg)[0])
        leaves, treedef = jax.tree.flatten(like)
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(inp[f"{arch}/param{i}"]) for i in range(len(leaves))])
        prompts = jnp.asarray(inp[f"{name}/prompts"].astype(np.int32))
        logits, states = jax.jit(lambda p, t: JE.prefill(
            p, cfg, t, chunk=CHUNK))(params, prompts)
        states = JE.pad_states_for_decode(cfg, states, n, n + GEN)
        step = jax.jit(lambda p, t, s, pos: JE.serve_step(
            p, cfg, t, s, pos, chunk=CHUNK))
        out[f"{name}/logits0"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks = []
        for i in range(GEN):
            toks.append(np.asarray(tok))
            logits, states = step(params, tok, states, jnp.int32(n + i))
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
    tmp = tmp_path_factory.mktemp("tp_serving")
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


@pytest.mark.parametrize("case", list(CASES))
def test_generate_returns_the_reference_tokens(runs, case):
    """``ServeSession(mesh=).generate``: the reference's greedy tokens,
    on every rank."""
    ref, ranks = runs[0], runs[1]
    for res in ranks:
        np.testing.assert_array_equal(res[f"{case}/generate"],
                                      ref[f"{case}/tokens"])


@pytest.mark.parametrize("case", list(CASES))
def test_caches_are_laid_out_batch_over_data_and_sequence_over_model(
        runs, case):
    """The first stacked cache leaf (n_periods, B, cap, KV, hd): this
    rank's rows of the batch when it divides by 'data', its chunk of the
    slots when the capacity divides by 'model', else whole."""
    _, b, n = CASES[case]
    for res in runs[1]:
        glob, loc = res[f"{case}/cache_global"], res[f"{case}/cache_local"]
        cap = glob[2]
        assert cap in (n + GEN, 16), glob          # gemma3's ring: 16
        assert loc[1] == (b // 2 if b % 2 == 0 else b), (glob, loc)
        assert loc[2] == (cap // 2 if cap % 2 == 0 else cap), (glob, loc)
        assert tuple(loc[3:]) == tuple(glob[3:])


def test_skipping_the_log_sum_exp_combine_leaves_the_tolerance(runs):
    """Each rank normalising its own slots (no combine over 'model'):
    the decode logits leave the tolerance the sound step meets; the
    prefill's stay (prefill attends whole caches)."""
    ref, ranks = runs[0], runs[1]
    for res in ranks:
        np.testing.assert_allclose(res[f"{FAULT}/fault/logits0"],
                                   ref[f"{FAULT}/logits0"], rtol=TOL,
                                   atol=TOL)
        assert not np.allclose(res[f"{FAULT}/fault/logits1"],
                               ref[f"{FAULT}/logits1"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("what", ["packet", "resync"])
def test_a_session_over_model_serves_only(runs, what):
    """Since item 7f's second part a ``ServeSession`` over 'model' does
    not serve only: it follows the weight stream.  Its parameters laid
    out over 'model' (``packet``): a full packet, then deltas, each applied with the
    one-device session's status and leaving the gathered parameters its
    bits; a dropped version refused as a ``gap`` by both, setting
    ``needs_resync``.  (``resync``): ``resync`` from ``save_full``
    restores the publisher's version and the one-device session's bits
    (themselves the published parameters), and ``generate`` then gives
    its tokens."""
    for res in runs[1]:
        if what == "packet":
            kinds = [str(res[f"stream/{i}/kind"])
                     for i in range(STREAM_PACKETS)]
            assert kinds == ["full"] + ["delta"] * (STREAM_PACKETS - 1)
            for i in range(STREAM_PACKETS):
                assert list(res[f"stream/{i}/status"]) == ["applied"] * 2
                assert bool(res[f"stream/{i}/same"]), i
            assert list(res["stream/gap"]) == ["gap", "gap"]
            assert bool(res["stream/needs_resync"])
        else:
            version = STREAM_PACKETS + 2
            assert list(res["stream/resync"]) == [version] * 3
            assert bool(res["stream/resync_same"])
            assert bool(res["stream/resync_full"])
            np.testing.assert_array_equal(res["stream/generate"],
                                          res["stream/generate_one"])


@pytest.mark.parametrize("arch", ONE_ARCHS)
def test_one_by_one_mesh_is_bitwise_the_one_device_path(runs, arch):
    """On a gloo world of one, serving at ("data", "model") = 1 × 1
    (the parameters and caches ``DTensor``s over one rank) gives the
    one-device path's logits and tokens, bit for bit."""
    res = runs[2]
    assert not bool(res[f"{arch}/none/dtensor"])
    assert bool(res[f"{arch}/1x1/dtensor"])
    for i in range(GEN + 1):
        np.testing.assert_array_equal(
            _bits(res[f"{arch}/1x1/logits{i}"]),
            _bits(res[f"{arch}/none/logits{i}"]), err_msg=f"step {i}")
    np.testing.assert_array_equal(res[f"{arch}/1x1/generate"],
                                  res[f"{arch}/none/generate"])


def _mesh(model: int):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: (2, model)[i])


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2",
                                  "llava_next_mistral_7b", "xlstm_1_3b",
                                  "jamba_v0_1_52b", "nemotron_4_340b"])
def test_check_mesh_refuses_what_is_left_naming_7f_second_part(arch):
    """Since item 7f's second part nothing of these is left: on a
    'model' axis of 2 the audio, VLM, SSM and hybrid families pass and
    take the tensor-parallel layout, and Nemotron-4-340B (whose copy
    over 'model' needs FSDP serving) takes it with FSDP.  What is left
    to refuse: an xLSTM whose 4 heads do not split over a 'model' axis
    of 8."""
    from repro_torch.configs import base
    from repro_torch.launch import serve as SV
    cfg = base.get_config(arch) if arch == "nemotron_4_340b" \
        else base.get_smoke_config(arch)
    SV.check_mesh(_mesh(2), cfg)
    SV.check_mesh(_mesh(1), cfg)
    assert SV.tensor_parallel(cfg, _mesh(2))
    assert SV.fsdp(cfg, _mesh(2)) == (arch == "nemotron_4_340b")
    if arch == "xlstm_1_3b":
        with pytest.raises(ValueError, match="heads do not split"):
            SV.check_mesh(_mesh(8), cfg)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "olmoe_1b_7b",
                                  "granite_moe_3b_a800m", "gemma3_27b"])
def test_check_mesh_admits_the_dense_and_moe_decoders(arch):
    """The dense and MoE decoders at full size pass on a 'model' axis of
    2, and their steps take the tensor-parallel layout."""
    from repro_torch.configs import base
    from repro_torch.launch import serve as SV
    cfg = base.get_config(arch)
    SV.check_mesh(_mesh(2), cfg)
    assert SV.tensor_parallel(cfg, _mesh(2))
    assert not SV.tensor_parallel(cfg, None)
