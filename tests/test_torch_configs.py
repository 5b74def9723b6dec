"""The port's config registry (``repro_torch.configs``) against the
reference's: every registered id's ``CONFIG`` and ``smoke_config()``
field for field, the input shapes, and the parameter counts, which the
port takes from its own model layout as ``meta`` tensors (no storage)
and the reference from ``jax.eval_shape`` of its init (the MoE configs'
active counts too).  Every registered family builds (Mamba's, the
last to raise naming ROADMAP.md item 13d, since the Jamba slice); what
still raises names item 7's tensor-parallel tail.
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import base as JB  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ALL_IDS = JB.ARCH_IDS + JB.PAPER_IDS
#: ids whose models the port builds, each counted at full size or at
#: smoke size (nemotron's)
BUILT = {"tinyllama_1_1b": "full", "llama3_8b": "full",
         "paper_lstm_ptb": "full", "nemotron_4_340b": "smoke",
         "gemma3_27b": "full", "granite_moe_3b_a800m": "full",
         "olmoe_1b_7b": "full", "xlstm_1_3b": "full",
         "seamless_m4t_large_v2": "full", "llava_next_mistral_7b": "full",
         "jamba_v0_1_52b": "full"}
#: id -> what the port refuses in it (nothing since Mamba's slice)
UNPORTED: dict = {}


def test_registry_lists_the_reference_ids():
    assert TB.ARCH_IDS == JB.ARCH_IDS
    assert TB.PAPER_IDS == JB.PAPER_IDS
    assert set(BUILT) | set(UNPORTED) | {"paper_cnn_cifar"} == set(ALL_IDS)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_configs_equal_the_reference_field_for_field(arch):
    assert dataclasses.asdict(TB.get_config(arch)) == \
        dataclasses.asdict(JB.get_config(arch))
    assert dataclasses.asdict(TB.get_smoke_config(arch)) == \
        dataclasses.asdict(JB.get_smoke_config(arch))
    # the reference's spellings of an id resolve the same way
    dashed = arch.replace("_", "-")
    assert TB.get_config(dashed) == TB.get_config(arch)


def test_gemma3_long_context_config_equals_the_reference():
    from repro.configs import gemma3_27b as jg
    from repro_torch.configs import gemma3_27b as tg
    assert dataclasses.asdict(tg.long_context_config()) == \
        dataclasses.asdict(jg.long_context_config())


def test_input_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in TB.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JB.INPUT_SHAPES.items()}
    assert TB.InputShape("x", 1, 2, "train") == TB.InputShape("x", 1, 2,
                                                              "train")


def _config(arch, size):
    return (TB.get_config(arch), JB.get_config(arch)) if size == "full" \
        else (TB.get_smoke_config(arch), JB.get_smoke_config(arch))


@pytest.mark.parametrize("arch", list(BUILT))
def test_param_count_equals_the_reference(arch):
    tcfg, jcfg = _config(arch, BUILT[arch])
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    # meta tensors: shapes without storage
    assert all(x.device.type == "meta"
               for x in tree.leaves(TT.abstract_params(tcfg)))


def test_param_counts_of_the_paper_lstm_and_tinyllama():
    """The published sizes: 55,524,000 (2 x 1500 sLSTM, vocab 10,000,
    11 leaves) and 1,100,048,384; and xLSTM-1.3B's 2,925,086,912, the
    reference's count."""
    assert TB.get_config("paper_lstm_ptb").param_count() == 55_524_000
    assert TB.get_config("tinyllama_1_1b").param_count() == 1_100_048_384
    assert TB.get_config("xlstm_1_3b").param_count() == 2_925_086_912


def test_param_counts_of_the_encoder_decoder_and_the_vlm():
    """The reference's counts: SeamlessM4T-Large-v2's 12 + 12 layers with
    cross-attention (31 leaves) and LLaVA-NeXT-Mistral-7B's language
    model (12 leaves; its vision tower is a stub)."""
    seamless = TB.get_config("seamless_m4t_large_v2")
    llava = TB.get_config("llava_next_mistral_7b")
    assert seamless.param_count() == 816_130_048
    assert llava.param_count() == 7_241_732_096
    assert seamless.active_param_count() == seamless.param_count()
    assert len(tree.leaves(TT.abstract_params(seamless))) == 31
    assert len(tree.leaves(TT.abstract_params(llava))) == 12


def test_moe_param_counts_total_and_active():
    """The reference's counts of the MoE configs: every parameter, and
    those a token runs (top_k of n_experts experts)."""
    granite = TB.get_config("granite_moe_3b_a800m")
    olmoe = TB.get_config("olmoe_1b_7b")
    assert granite.param_count() == 3_298_793_472
    assert granite.active_param_count() == 882_874_368
    assert olmoe.param_count() == 6_919_096_320
    assert olmoe.active_param_count() == 1_281_951_744
    dense = TB.get_config("tinyllama_1_1b")
    assert dense.active_param_count() == dense.param_count()


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b"])
def test_unported_families_raise_naming_item_13d(arch):
    """The family that raised naming item 13d (Mamba's) counts and builds
    now, at both sizes: Jamba-v0.1's 51,570,315,264 parameters
    (12,110,303,232 active: top 2 of 16 experts), the reference's
    counts, and its smoke model runs."""
    full = TB.get_config(arch)
    assert full.param_count() == 51_570_315_264
    assert full.active_param_count() == 12_110_303_232
    assert not UNPORTED
    cfg = TB.get_smoke_config(arch)
    assert cfg.param_count() == JB.get_smoke_config(arch).param_count()
    module = TT.Transformer(cfg, device="cpu")
    assert "mamba" in module.params["decoder"]["blocks"][0]
    hidden, _ = module(torch.zeros((1, 3), dtype=torch.int32))
    assert tuple(hidden.shape) == (1, 3, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())


@pytest.mark.parametrize("what", ["train_step", "profile_model",
                                  "moe_forward_ep"])
def test_tensor_parallel_tail_raises_naming_item_7(what):
    """Of the port's tensor-parallel tail (ROADMAP.md queue 1 item 7)
    only the MoE token groups that span a pod's ranks beside a 'model'
    axis still raise, naming item 7e's third part.  What raised here
    before item 7g runs on a ``model`` axis: xLSTM's train step with the
    health quantities (``lags_hier2``'s whole-leaf path; at data 1 ×
    model 1 its health keys and loss are the data-only mesh's, bit for
    bit), and the autotune profiler (one data worker, the mesh's (1, 1)
    shape, the data-only profile's FLOPs; its bytes count the DTensor
    step's own ops)."""
    from repro_torch.autotune import profiler as PR
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as LT
    if what == "moe_forward_ep":
        with pytest.raises(NotImplementedError,
                           match="item 7.*tensor-parallel"):
            LT.pod_auto_moe_groups(4, 2, 2, model=2)
        return
    from test_torch_spawn import world_of_one
    cfg = TB.get_smoke_config("xlstm_1_3b")
    got = {}
    with world_of_one():
        for mesh in (M.make_mesh(device="cpu"),
                     M.make_mesh(model=1, device="cpu")):
            if what == "profile_model":
                got[mesh.mesh_dim_names] = PR.profile_model(
                    cfg, mesh, seq=16, global_batch=2, iters=1,
                    comm_sizes=(4096,))
                continue
            from repro_torch import api
            sess = api.Session(cfg, api.RunConfig(
                mode="lags_hier2", health_every=1, chunk=8, loss_chunk=8),
                mesh=mesh)
            state, _ = sess.init_state(seed=0)
            batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=0).batch(
                0, 2, 16, device="cpu")
            got[mesh.mesh_dim_names] = sess.step_fn(state, batch)[1]
    flat, tp = got[("data",)], got[("data", "model")]
    if what == "profile_model":
        assert (tp.n_workers, tuple(tp.mesh_shape)) == (1, (1, 1))
        assert tp.flops_per_step == flat.flops_per_step > 0
        assert tp.hbm_bytes_per_step > 0 and tp.t_step_lags > 0
        return
    assert sorted(tp) == sorted(flat)
    assert {"health_delta", "health_ef_energy_outer"} <= set(tp)
    for k in flat:
        assert torch.equal(tp[k], flat[k]), k
