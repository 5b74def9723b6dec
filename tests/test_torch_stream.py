"""The port's weight stream (``repro_torch.stream``) against the
reference's ``repro.stream``.

Bitwise where the reference is: ``DeltaCodec.encode``'s payload and
residual under ``topk_exact`` and ``topk_block`` on f32 and bf16 leaves
whose |acc| holds exact ties (dyadic f32 deltas; differences of bf16
values), ``tree_fingerprint``, packets saved by one package and applied
by the other, and ``StreamPublisher.split_budget``'s per-leaf k under a
byte and a time budget.  Then the behaviour tests of
``tests/test_stream.py`` on the port: the EF invariant, the exact dense
fallback, the bitwise follow after a flush, gaps, foreign and stale
packets, ``generate`` against the engine, the rollout guard, and
``Session.run(publisher=...)`` on a gloo world of one.
"""
import dataclasses
import tempfile

import ml_dtypes
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import comm_model as jcm  # noqa: E402
from repro.stream import codec as JCD  # noqa: E402
from repro.stream import publisher as JPB  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.core import comm_model as tcm  # noqa: E402
from repro_torch.core import compressors as TC  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.stream import (DeltaCodec, DeltaPacket,  # noqa: E402
                                RolloutGuard, ServeSession, StreamPublisher,
                                load_packet, quality_probe, save_packet,
                                tree_fingerprint)
from repro_torch.stream import codec as CD  # noqa: E402

#: leaf shapes of the parity trees: "big" spans two 4096-blocks with a
#: ragged tail (topk_block pads it)
SHAPES = {"w": (16, 16), "b": (24,), "emb": {"table": (32, 8)},
          "big": (5000,)}
KS = {"w": 20, "b": 5, "emb/table": 17, "big": 300}


def _map_shapes(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _map_shapes(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _np_trees(dtype: str, seed: int = 0):
    """(published, now, residual) as numpy f32 (values exact in
    ``dtype``).  f32: dyadic parameters and deltas from {±1, ±2, ±3}/256,
    so ``now - published`` is exact and |acc| ties everywhere; bf16: the
    difference of two bf16 trees, coarsely quantized."""
    rng = np.random.default_rng(seed)

    def pair(shape):
        if dtype == "float32":
            pub = rng.integers(-512, 512, shape) / 256.0
            step = rng.choice([-3, -2, -1, 1, 2, 3], shape) / 256.0
            return pub.astype(np.float32), (pub + step).astype(np.float32)
        pub = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        now = (pub.astype(np.float32) + 0.02 * rng.standard_normal(shape))
        return (pub.astype(np.float32),
                now.astype(ml_dtypes.bfloat16).astype(np.float32))

    pairs = _map_shapes(pair, SHAPES)
    pub = jax.tree.map(lambda p: p[0], pairs,
                       is_leaf=lambda x: isinstance(x, tuple))
    now = jax.tree.map(lambda p: p[1], pairs,
                       is_leaf=lambda x: isinstance(x, tuple))
    res = {k: (rng.integers(-2, 3, int(np.prod(np.shape(v)))) / 512.0)
           .astype(np.float32) for k, v in CD.leaf_items(pub)}
    return pub, now, res


def _jax_tree(np_tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), np_tree)


def _torch_tree(np_tree, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return tree.map(lambda a: torch.from_numpy(np.asarray(a)).to(tdt)
                    .clone(), np_tree)


def _bits(x):
    """Exact bit pattern of a numpy, JAX or torch array, as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint8)


def _same(a, b):
    return np.array_equal(_bits(a), _bits(b))


def _bitwise_trees(a, b):
    """A port tree against a reference tree (or another port tree), leaf
    for leaf in the shared flatten order, bit for bit."""
    la, lb = tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(_same(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compressor", ["topk_exact", "topk_block"])
def test_encode_bitwise_matches_reference(compressor, dtype):
    pub, now, res = _np_trees(dtype)
    jc = JCD.DeltaCodec(_jax_tree(pub, dtype), compressor=compressor)
    tc = DeltaCodec(_torch_tree(pub, dtype), compressor=compressor)
    jpay, jres, jn, jkinds = jc.encode(
        _jax_tree(pub, dtype), _jax_tree(now, dtype), res, KS)
    tpay, tres, tn, tkinds = tc.encode(
        _torch_tree(pub, dtype), _torch_tree(now, dtype),
        {k: torch.from_numpy(v) for k, v in res.items()}, KS)
    assert (tn, tkinds) == (jn, jkinds)
    assert set(tkinds.values()) == {"sparse"}
    ties = 0
    for key in jc.keys:
        for field in ("values", "idx"):
            assert _same(tpay[key][field], jpay[key][field]), (key, field)
        assert _same(tres[key], jres[key]), key
        # the selection boundary sits inside a run of equal |acc|
        acc = np.abs(jres[key] + JCD.C.decompress(
            jnp.asarray(jpay[key]["values"]), jnp.asarray(jpay[key]["idx"]),
            jc.sizes[key]))
        ties += int(np.sum(acc == acc[jpay[key]["idx"][-1]]) > 1)
    assert ties >= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fingerprint_equals_reference(dtype):
    pub, _, _ = _np_trees(dtype)
    assert tree_fingerprint(_torch_tree(pub, dtype)) == \
        JCD.tree_fingerprint(_jax_tree(pub, dtype))
    assert tree_fingerprint(_torch_tree(pub, "float32")) != \
        tree_fingerprint(_torch_tree(pub, "bfloat16"))


def _ref_view_bf16(pkt):
    """The reference's loader returns bf16 leaves as ``'V2'`` records,
    which its own apply cannot take (for its own packets as for the
    port's); view them as ml_dtypes bf16 first."""
    return dataclasses.replace(pkt, payload={
        k: {f: (a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" else a)
            for f, a in e.items()} for k, e in pkt.payload.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["delta", "full"])
def test_packets_cross_between_packages(tmp_path, dtype, kind):
    """A packet saved by either package loads in the other and applies to
    the same bits as the saving package's own apply."""
    pub, now, res = _np_trees(dtype, seed=4)
    jpub, tpub = _jax_tree(pub, dtype), _torch_tree(pub, dtype)
    jc, tc = JCD.DeltaCodec(jpub), DeltaCodec(tpub)
    if kind == "delta":
        jpay, _, jn, _ = jc.encode(jpub, _jax_tree(now, dtype), res, KS)
        tpay, _, tn, _ = tc.encode(
            tpub, _torch_tree(now, dtype),
            {k: torch.from_numpy(v) for k, v in res.items()}, KS)
    else:
        jpay, _, jn = jc.encode_full(_jax_tree(now, dtype))
        tpay, _, tn = tc.encode_full(_torch_tree(now, dtype))
    jpkt = JCD.DeltaPacket(3, 7, jc.fingerprint, kind, jpay, jn)
    tpkt = DeltaPacket(3, 7, tc.fingerprint, kind, tpay, tn)
    want = jc.apply(jpub, jpkt, donate=False)
    assert _bitwise_trees(tc.apply(tpub, tpkt, donate=False), want)
    # the reference's file, applied by the port
    got = load_packet(JCD.save_packet(str(tmp_path / "j"), jpkt))
    assert (got.version, got.step, got.kind, got.nbytes,
            got.fingerprint) == (3, 7, kind, jn, tc.fingerprint)
    assert _bitwise_trees(tc.apply(_torch_tree(pub, dtype), got), want)
    # the port's file, applied by the reference
    back = _ref_view_bf16(JCD.load_packet(save_packet(str(tmp_path / "t"),
                                                      tpkt)))
    assert back.fingerprint == jc.fingerprint
    assert _bitwise_trees(tc.apply(tpub, tpkt, donate=False),
                          jc.apply(jpub, back, donate=False))


def _plans(**kw):
    pub, _, _ = _np_trees("float32")
    jkw = dict(kw)
    if "hw" in kw:
        jkw["hw"] = jcm.Hardware(**dataclasses.asdict(kw["hw"]))
    jplan = JPB.StreamPublisher(_jax_tree(pub, "float32"),
                                **jkw).split_budget()
    tplan = StreamPublisher(_torch_tree(pub, "float32"), **kw).split_budget()
    return tplan, jplan


@pytest.mark.parametrize("budget", [200, 400, 4000, 40_000])
def test_split_budget_equals_reference_under_bytes(budget):
    tplan, jplan = _plans(budget_bytes=budget)
    assert [(e.key, e.d, e.k, e.kind, e.nbytes) for e in tplan] == \
        [(e.key, e.d, e.k, e.kind, e.nbytes) for e in jplan]


@pytest.mark.parametrize("t_budget", [1e-5, 1e-4, 1e-3])
def test_split_budget_equals_reference_under_time(t_budget):
    tplan, jplan = _plans(hw=tcm.H100_NVLINK, p=4, time_budget_s=t_budget)
    assert [(e.key, e.k, e.kind) for e in tplan] == \
        [(e.key, e.k, e.kind) for e in jplan]
    assert [e.t_pred for e in tplan] == pytest.approx(
        [e.t_pred for e in jplan], rel=1e-12)
    assert all(e.t_pred > 0.0 for e in tplan)


# ---------------------------------------------------------------------------
# codec and publisher behaviour (tests/test_stream.py)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 16), generator=g),
            "b": torch.randn((24,), generator=g),
            "emb": {"table": torch.randn((32, 8), generator=g)}}


def _drift(tree_, seed, scale=1e-2):
    g = torch.Generator().manual_seed(1000 + seed)
    return tree.map(lambda x: x + scale * torch.randn(
        x.shape, generator=g).to(x.dtype), tree_)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b)))


def _zeros_like(tree_):
    return tree.map(torch.zeros_like, tree_)


@pytest.mark.parametrize("compressor", ["topk_exact", "topk_block_kernel",
                                        "topk_hier_ef_kernel"])
def test_ef_invariant_selected_plus_residual_is_acc(compressor):
    """Nothing is dropped: selected + residual' == residual + delta,
    elementwise exact, under the plain and the kernel-backed compressors
    (their plain versions on the CPU)."""
    codec = DeltaCodec(_tree(), compressor=compressor)
    pub, now = _tree(), _drift(_tree(), 1)
    res = {k: torch.full((codec.sizes[k],), 1e-3) for k in codec.keys}
    payload, res2, _, kinds = codec.encode(pub, now, res, {k: 5 for k in
                                                           codec.keys})
    for key, now_leaf in CD.leaf_items(now):
        assert kinds[key] == "sparse"
        acc = res[key] + (now_leaf.reshape(-1)
                          - dict(CD.leaf_items(pub))[key].reshape(-1))
        dense = TC.decompress(payload[key]["values"], payload[key]["idx"],
                              codec.sizes[key])
        assert torch.equal(dense + res2[key], acc)
        assert torch.all(res2[key][payload[key]["idx"].long()] == 0.0)
    if compressor == "topk_block_kernel":
        plain = DeltaCodec(_tree(), compressor="topk_block").encode(
            pub, now, res, {k: 5 for k in codec.keys})[0]
        assert all(torch.equal(payload[k][f], plain[k][f])
                   for k in codec.keys for f in ("values", "idx"))


def test_dense_fallback_is_exact():
    codec = DeltaCodec(_tree())
    pub, now = _tree(), _drift(_tree(), 2)
    payload, res2, nbytes, kinds = codec.encode(
        pub, now, codec.zero_residual(),
        {k: codec.sizes[k] for k in codec.keys})
    assert all(v == "full" for v in kinds.values())
    assert nbytes == codec.full_bytes
    assert all(torch.all(r == 0.0) for r in res2.values())
    pkt = DeltaPacket(version=1, step=0, fingerprint=codec.fingerprint,
                      kind="delta", payload=payload, nbytes=nbytes)
    assert _bitwise(codec.apply(pub, pkt, donate=False), now)


def test_sparse_wins_boundary_and_structure_fingerprint():
    codec = DeltaCodec(_tree())
    d = codec.sizes["b"]
    assert codec.sparse_wins("b", (d * 4) // codec.bpe - 1)
    assert not codec.sparse_wins("b", d)
    assert tree_fingerprint(_tree(0)) == tree_fingerprint(_tree(9))
    other = dict(_tree(), extra=torch.zeros(3))
    assert tree_fingerprint(other) != tree_fingerprint(_tree())
    with pytest.raises(ValueError, match="deterministic"):
        DeltaCodec(_tree(), compressor="randk")


def test_apply_donates_in_place_and_guarded_apply_copies():
    codec = DeltaCodec(_tree())
    pub, now = _tree(), _drift(_tree(), 3)
    payload, _, nbytes, _ = codec.encode(pub, now, codec.zero_residual(),
                                         {k: 4 for k in codec.keys})
    pkt = DeltaPacket(1, 0, codec.fingerprint, "delta", payload, nbytes)
    before = tree.map(torch.clone, pub)
    fresh = codec.apply(pub, pkt, donate=False)
    assert _bitwise(pub, before)                 # untouched
    out = codec.apply(pub, pkt)                  # in place
    assert all(a is b for a, b in zip(tree.leaves(out), tree.leaves(pub)))
    assert _bitwise(pub, fresh)
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(tree.leaves(fresh), tree.leaves(pub)))


def test_packet_disk_roundtrip(tmp_path):
    codec = DeltaCodec(_tree())
    payload, _, nbytes, _ = codec.encode(
        _tree(), _drift(_tree(), 3), codec.zero_residual(),
        {k: 4 for k in codec.keys})
    pkt = DeltaPacket(version=7, step=42, fingerprint=codec.fingerprint,
                      kind="delta", payload=payload, nbytes=nbytes)
    got = load_packet(save_packet(str(tmp_path), pkt))
    assert (got.version, got.step, got.kind, got.nbytes,
            got.fingerprint) == (7, 42, "delta", nbytes, codec.fingerprint)
    assert all(torch.equal(got.payload[k][f], pkt.payload[k][f])
               for k in pkt.payload for f in pkt.payload[k])


def test_first_packet_full_then_budgeted_deltas():
    pub = StreamPublisher(_tree(), every=1, budget_bytes=256)
    p1 = pub.publish(0, _tree())
    assert p1.kind == "full" and p1.version == 1
    for step in range(1, 5):
        pkt = pub.publish(step, _drift(_tree(), step))
        assert pkt.kind == "delta" and pkt.nbytes <= 256
    assert pub.version == 5
    assert StreamPublisher(_tree(), every=5, bytes_per_sec=100.0,
                           step_time_s=2.0).budget_bytes == 1000


def test_split_proportional_to_leaf_size():
    plan = {e.key: e for e in StreamPublisher(
        _tree(), budget_bytes=400).split_budget()}
    assert sum(e.nbytes for e in plan.values()) <= 400
    assert plan["w"].k > plan["b"].k and plan["w"].d == 256


def test_flush_every_drains_on_schedule():
    pub = StreamPublisher(_tree(), every=1, budget_bytes=128, flush_every=3)
    kinds = [pub.publish(s, _drift(_tree(), s)).kind for s in range(6)]
    assert kinds == ["full", "delta", "full", "delta", "delta", "full"]


def test_acceptance_bytes_and_bitwise_parity():
    """The stream costs <= 25% of full checkpoints at a matched cadence;
    a subscriber applying every packet equals the publisher mid-stream,
    and the live parameters after a flush."""
    pub = StreamPublisher(_tree(), every=1,
                          budget_bytes=DeltaCodec(_tree()).full_bytes // 10)
    sub, live = None, _tree()
    for step in range(8):
        live = _drift(live, 100 + step, scale=1e-3)
        pkt = pub.publish(step, live)
        sub = (pub.codec.materialize(pkt, _zeros_like(live)) if sub is None
               else pub.codec.apply(sub, pkt))
        assert _bitwise(sub, pub.published)
    assert pub.bytes_streamed <= 0.25 * pub.bytes_full_equiv
    assert not _bitwise(sub, live)
    sub = pub.codec.apply(sub, pub.flush(8, live))
    assert _bitwise(sub, live)


def test_publish_encodes_through_the_codec_once_a_packet():
    """Every packet is cut by one call of the codec's ``encode`` (delta)
    or ``encode_full`` (full), the path its timing wraps, and the stream
    health gauge reads ``||res'||^2 / ||acc||^2`` of that encode (0 after
    a full packet)."""
    from repro_torch.observe import metrics as OM
    from repro_torch.observe import names as ON
    reg = OM.MetricsRegistry()
    pub = StreamPublisher(_tree(), every=1, budget_bytes=256, flush_every=4,
                          metrics=reg)
    calls = []
    for name in ("encode", "encode_full"):
        def counted(*args, _fn=getattr(pub.codec, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        setattr(pub.codec, name, counted)
    gauge = reg.get("publish_health_ef_energy")
    live = _tree()
    for step in range(6):
        live = _drift(live, 200 + step)
        want = None
        if pub.published is not None:
            acc = {k: pub.residual[k] + (v.float().reshape(-1)
                                         - p.float().reshape(-1))
                   for (k, v), (_, p) in zip(CD.leaf_items(live),
                                             CD.leaf_items(pub.published))}
        pkt = pub.publish(step, live)
        if pkt.kind == "delta":
            want = {k: float(torch.sum(torch.square(pub.residual[k])))
                    / float(torch.sum(torch.square(acc[k])))
                    for k in pub.codec.keys}
        for key in pub.codec.keys:
            got = gauge.value(leaf=ON.health_name("ef_energy",
                                                  f"stream/{key}"))
            assert got == (0.0 if want is None else want[key])
    assert calls == ["encode_full", "encode", "encode", "encode_full",
                     "encode", "encode"]
    assert [p.kind for p in pub.packets] == [
        "full", "delta", "delta", "full", "delta", "delta"]


def test_kept_packets_are_host_copies_that_replay_the_stream():
    """``publisher.packets`` holds every packet with its payload on the
    host (as the reference's numpy packets); replayed in order onto
    zeros they give the publisher's ``published`` copy bit for bit, and
    the payloads equal the packets ``publish`` returned."""
    pub = StreamPublisher(_tree(), every=1, budget_bytes=256)
    live, returned = _tree(), []
    for step in range(5):
        live = _drift(live, 200 + step)
        returned.append(pub.publish(step, live))
    assert [p.version for p in pub.packets] == [1, 2, 3, 4, 5]
    sub = None
    for kept, pkt in zip(pub.packets, returned):
        assert (kept.version, kept.kind, kept.nbytes) == (
            pkt.version, pkt.kind, pkt.nbytes)
        for key, entry in kept.payload.items():
            for f, v in entry.items():
                assert v.device.type == "cpu"
                assert torch.equal(v, pkt.payload[key][f].cpu())
        sub = (pub.codec.materialize(kept, _zeros_like(live)) if sub is None
               else pub.codec.apply(sub, kept))
    assert _bitwise(sub, pub.published)


def test_save_full_records_stream_position(tmp_path):
    from repro_torch.checkpoint import io
    pub = StreamPublisher(_tree(), every=1, budget_bytes=128)
    for step in range(3):
        pub.publish(step, _drift(_tree(), step))
    meta = io.load_metadata(pub.save_full(str(tmp_path / "full"),
                                          step=2))["metadata"]
    assert (meta["version"], meta["step"], meta["fingerprint"]) == \
        (3, 2, pub.codec.fingerprint)


# ---------------------------------------------------------------------------
# subscriber and guard over a served model
# ---------------------------------------------------------------------------

def _model_cfg():
    return dataclasses.replace(
        TB.get_smoke_config("tinyllama_1_1b"), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=64, dtype="float32",
        param_dtype="float32", compression_ratio=1.0)


def _shape(seq=8, batch=2):
    return TB.InputShape("serve", seq, batch, "decode")


@pytest.fixture(scope="module")
def served():
    cfg = _model_cfg()
    return cfg, TT.init_params(cfg, device="cpu")


def test_follow_stream_bitwise(served, tmp_path):
    cfg, params = served
    pub = StreamPublisher(params, every=1,
                          budget_bytes=DeltaCodec(params).full_bytes // 10,
                          out_dir=str(tmp_path))
    sub = ServeSession(cfg, _shape(), _zeros_like(params))
    live = params
    for step in range(4):
        live = _drift(live, step, scale=1e-3)
        pub.publish(step, live)
    pub.flush(4, live)
    for path in pub.packet_paths:
        assert sub.apply_packet_file(path) == "applied"
    assert sub.version == pub.version == 5
    assert _bitwise(sub.params, live)
    assert _bitwise(sub.params, pub.published)


def test_gap_refused_then_resync(served, tmp_path):
    cfg, params = served
    pub = StreamPublisher(params, every=1, budget_bytes=512)
    sub = ServeSession(cfg, _shape(), _zeros_like(params))
    pkts = [pub.publish(s, _drift(params, s)) for s in range(4)]
    assert sub.apply_packet(pkts[0]) == "applied"
    before = tree.map(torch.clone, sub.params)
    assert sub.apply_packet(pkts[2]) == "gap"
    assert sub.needs_resync and _bitwise(sub.params, before)
    path = pub.save_full(str(tmp_path / "resync"), step=3)
    assert sub.resync(path) == pub.version == 4
    assert not sub.needs_resync
    assert _bitwise(sub.params, pub.published)
    assert sub.apply_packet(pub.publish(4, _drift(params, 9))) == "applied"


def test_foreign_and_stale_packets_refused(served):
    cfg, params = served
    pub = StreamPublisher(params, every=1, budget_bytes=512)
    sub = ServeSession(cfg, _shape(), _zeros_like(params))
    p1 = pub.publish(0, params)
    assert sub.apply_packet(p1) == "applied"
    assert sub.apply_packet(p1) == "stale"
    alien = dataclasses.replace(pub.publish(1, _drift(params, 1)),
                                fingerprint="deadbeef")
    assert sub.apply_packet(alien) == "fingerprint"
    assert sub.needs_resync
    assert [r["status"] for r in sub.log] == ["applied", "stale",
                                              "fingerprint"]


def test_generate_matches_direct_engine_path(served):
    from repro_torch.serving import engine
    cfg, params = served
    sub = ServeSession(cfg, _shape(), params, chunk=16)
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 4)).astype(np.int32))
    got = sub.generate(prompts, 3)
    assert got.shape == (2, 3) and got.dtype == torch.int32
    logits, st = engine.prefill(params, cfg, prompts, chunk=16)
    st = engine.pad_states_for_decode(cfg, st, 4, 7)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    want = []
    for i in range(3):
        want.append(tok)
        logits, st = engine.serve_step(params, cfg, tok, st, 4 + i,
                                       chunk=16)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    assert torch.equal(got, torch.cat(want, dim=1))
    sub.generate(prompts, 3)
    r0, r1 = sub.requests
    assert (r0.prefill_jit, r0.decode_jit) == ("miss", "miss")
    assert (r1.prefill_jit, r1.decode_jit) == ("hit", "hit")
    assert (r1.index, r1.batch, r1.prompt_len, r1.n_tokens, r1.cache) == \
        (1, 2, 4, 3, "full")
    assert r1.decode_tok_s > 0 and r1.prefill_s > 0


def _guard(cfg):
    from repro_torch.launch import specs as SP
    batch = SP.concrete_batch(cfg, TB.InputShape("t", 16, 2, "train"),
                              seed=11, device="cpu")
    return RolloutGuard(quality_probe(cfg, batch, chunk=16, loss_chunk=16))


def test_guard_regression_trips_and_pins(served):
    """Gentle drift streams quietly; a poisoned packet jumps the held-out
    NLL, the guard fires before commit, the last-good version is pinned
    and stays live."""
    cfg, params = served
    guard = _guard(cfg)
    pub = StreamPublisher(params, every=1, budget_bytes=512)
    sub = ServeSession(cfg, _shape(), _zeros_like(params), guard=guard)
    live = params
    for step in range(4):
        live = _drift(live, step, scale=1e-4)
        assert sub.apply_packet(pub.publish(step, live)) == "applied"
    assert not guard.halted and guard.last_nll is not None
    good = tree.map(torch.clone, sub.params)
    pkt = pub.flush(4, tree.map(lambda x: x + 50.0, live))
    assert sub.apply_packet(pkt) == "halted"
    assert guard.halted and guard.anomaly is not None
    assert guard.pinned_version == sub.version == 4
    assert _bitwise(sub.params, good)
    nll_at_halt = guard.last_nll
    assert sub.apply_packet(pub.publish(5, live)) == "halted"
    assert guard.last_nll == nll_at_halt
    guard.resume()
    assert guard.allow() and not guard.halted


def test_guard_quiet_on_gentle_drift(served):
    cfg, params = served
    guard = _guard(cfg)
    pub = StreamPublisher(params, every=1, budget_bytes=512)
    sub = ServeSession(cfg, _shape(), _zeros_like(params), guard=guard)
    live = params
    for step in range(6):
        live = _drift(live, 30 + step, scale=1e-4)
        assert sub.apply_packet(pub.publish(step, live)) == "applied"
    assert not guard.halted and len(guard.samples) == 6


def test_session_run_offers_params_every_step(tmp_path):
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    cfg = dataclasses.replace(_model_cfg(), train_mode="lags_dp",
                              compression_ratio=8.0)
    shape = TB.InputShape("t", 16, 4, "train")
    with tempfile.NamedTemporaryFile() as f:
        M.init_process_group(f"file://{f.name}", 1, 0, device="cpu")
        try:
            sess = api.Session(cfg, api.RunConfig(
                lr=0.1, chunk=16, loss_chunk=16, donate=False),
                mesh=M.make_mesh(device="cpu"))
            state, _ = sess.init_state()
            pub = StreamPublisher(state["params"], every=2,
                                  out_dir=str(tmp_path))
            _, history = sess.run(
                lambda t: SP.concrete_batch(cfg, shape, seed=t,
                                            device="cpu"),
                4, state=state, publisher=pub, print_fn=lambda *_: None)
        finally:
            dist.destroy_process_group()
    published = [r["publish"] for r in history if "publish" in r]
    assert [p["version"] for p in published] == [1, 2]
    assert published[0]["kind"] == "full"
    assert pub.n_publishes == 2 and len(pub.packet_paths) == 2
    assert load_packet(pub.packet_paths[-1]).version == 2


def test_api_exports_and_compressor_registry_match_reference():
    """``repro_torch.api`` exports the reference's names; a compressor
    registered through ``register_compressor`` is what the codec runs."""
    from repro import api as japi
    from repro_torch import api as tapi
    assert tapi.__all__ == japi.__all__
    assert set(japi.compressor_names()) <= set(tapi.compressor_names())
    calls = []

    @tapi.register_compressor("test_first_k")
    def first_k(x, k):
        calls.append(k)
        return x[:k], torch.arange(k, dtype=torch.int32)

    try:
        assert tapi.get_compressor("test_first_k").compress is first_k
        assert "test_first_k" in tapi.compressor_names()
        codec = DeltaCodec(_tree(), compressor="test_first_k")
        payload, _, _, _ = codec.encode(_tree(), _drift(_tree(), 5),
                                        codec.zero_residual(),
                                        {k: 3 for k in codec.keys})
        assert calls == [3, 3, 3]
        assert torch.equal(payload["b"]["idx"], torch.arange(3,
                                                             dtype=torch.int32))
    finally:
        TC.REGISTRY.pop("test_first_k")
