"""The CUDA selection kernels and the port's training path on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  The
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, kernels, tree  # noqa: E402
from repro_torch.configs import tinyllama_1_1b  # noqa: E402
from repro_torch.kernels import ef_sparsify, ref  # noqa: E402
from repro_torch.kernels.block_topk import block_topk  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g = g.float() if g.dtype == torch.bfloat16 else g
        w = w.float() if w.dtype == torch.bfloat16 else w
        assert torch.equal(g.contiguous().view(torch.int32).cpu(),
                           w.contiguous().view(torch.int32).cpu())


@pytest.mark.parametrize("bs", [4096, 130, 1023])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_bitwise(cuda, bs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(bs)
    g = torch.randn((37, bs), generator=gen, device=cuda).to(dtype)
    e = torch.randn((37, bs), generator=gen, device=cuda)
    for k in (1, 4, 5, bs):
        _bitwise(block_topk(g, k), ref.block_topk_ref(g, k))
        for thr in (None, 0.5):
            _bitwise(ef_sparsify.ef_select_pack(g, e, 1.0, thr, k),
                     ref.ef_select_pack_ref(g, e, 1.0, thr, k))
        _bitwise(ef_sparsify.ef_block_candidates(g, e, 0.3, k),
                 ref.ef_block_candidates_ref(g, e, 0.3, k))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn((4, 256), device=cuda)
    with pytest.raises(ValueError, match="outside"):
        block_topk(x, 257)
    with pytest.raises(TypeError):
        block_topk(x.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        block_topk(torch.randn((256, 4), device=cuda).t(), 4)
    big = torch.zeros((1, 40_000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ef_sparsify.ef_select_pack(big, big, 1.0, None, 4)
    with pytest.raises(ValueError, match="shape"):
        ef_sparsify.ef_select_pack(x, x[:2], 1.0, None, 4)


def test_launch_counts_move_only_on_a_launch(cuda):
    kernels.reset_launch_counts()
    x = torch.randn((3, 512), device=cuda)
    block_topk(x, 2)
    block_topk(x.cpu(), 2)                       # plain version: no launch
    ef_sparsify.ef_select_pack(x, x, 1.0, None, 2)
    assert kernels.launch_counts() == {"block_topk": 1, "ef_select_pack": 1,
                                       "ef_block_candidates": 0}


@pytest.mark.parametrize("compressor", ["topk_exact", "topk_block",
                                        "topk_hier"])
def test_training_on_the_card_tracks_the_cpu(cuda, compressor):
    """Two steps of the kernel-backed SimTrainer on the card and on the
    CPU (plain versions), f32 smoke model: losses and parameters agree to
    1e-4 (matmul and reduction order differ between the devices)."""
    torch.use_deterministic_algorithms(False)
    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), n_layers=1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2, 32),
                                     generator=torch.Generator().manual_seed(0))}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=-1)
    out = {}
    for dev in ("cpu", "cuda"):
        model = TT.Transformer(cfg, seed=0, device="cpu")
        model.to(dev)                  # moves the Parameters in place
        params = model.params
        run = api.RunConfig(mode="lags_dp", ratio=16.0, lr=0.1,
                            compressor=compressor, selection_backend="kernel",
                            block_size=1024)
        tr = api.Session(cfg, run, device=dev).simulator(
            lambda p, b: TT.loss_fn(p, cfg, b, chunk=16, loss_chunk=16),
            params, n_workers=2)
        losses = [float(tr.step({k: v.to(dev) for k, v in batch.items()})
                        ["loss"]) for _ in range(2)]
        out[dev] = (losses, [p.detach().cpu() for p in tree.leaves(params)])
    assert out["cpu"][0] == pytest.approx(out["cuda"][0], rel=1e-4)
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
