"""Batch-composition invariance on the card, in bf16: one (request, seed)
gives the same 220 tokens alone and at B = 8, 16, 32, 64, at the first, the
middle and the last row, among two different sets of neighbours, on the service's three
decode paths (the per-layer step with an int8 cache and with a bf16 cache,
and the whole-step kernel); every op the repair touched gives a row the
same bits at every row count; and the encoder with each channel kind beside
the default GRU (LSTM, RNN, 2-layer GRU, TRM; full width, seeded weights)
gives a row the same outputs alone and among M = 8 to 64 rows, in bf16 and
in f32.

Marked ``cuda``: it skips where PyTorch sees no CUDA device. Run it on a GPU
machine with ``python -m pytest --noconftest
tests/test_torch_batch_invariance_cuda.py`` (the shared conftest imports jax,
which such a machine need not have). ``chip_smoke.py`` phase 25 runs the
same checks with one set of neighbours.
"""

import pytest
import torch

from mmtg_tpu_torch.tools import batch_invariance as bi

pytestmark = pytest.mark.cuda

BATCHES = (1, 8, 16, 32, 64)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return bi.full_size_model(0, torch.bfloat16, "cuda")


@pytest.mark.parametrize("path", sorted(bi.PATHS))
def test_tokens_do_not_depend_on_the_batch(model, path):
    mcfg, dcfg, params, const = model
    gen = torch.Generator(device="cuda").manual_seed(16)
    sample = bi.random_rows(1, mcfg, dcfg, gen, torch.bfloat16, "cuda")
    neighbours = [bi.random_rows(max(BATCHES), mcfg, dcfg, gen, torch.bfloat16, "cuda")
                  for _ in range(2)]
    res = bi.decode_paths(params, const, mcfg, dcfg, sample, neighbours, BATCHES, 220,
                          paths={path: bi.PATHS[path]})[path]
    assert len(res["runs"]) == 2 * 4 * 3  # neighbour sets x batches x rows
    assert res["first_diff"] is None, [r for r in res["runs"] if r["first_diff"] is not None]


def test_the_ports_ops_do_not_depend_on_the_row_count(model):
    """Every op the port runs (the probe's ops but the replaced library
    calls), in bf16 and in f32 (where any change of summation order shows)."""
    from mmtg_tpu_torch.params import tree_to

    mcfg, dcfg, params, _ = model
    for p, dtype in ((params, torch.bfloat16),
                     (tree_to(params, dtype=torch.float32), torch.float32)):
        ops = bi.op_probe(p, mcfg, dcfg, BATCHES, dtype, library=False)
        assert ops and not any(k.endswith(bi.LIBRARY) for k in ops)
        assert {k: v["differs"] for k, v in ops.items() if v["differs"]} == {}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(bi.CHANNELS))
def test_channel_encoders_do_not_depend_on_the_row_count(name, dtype):
    """``encoder_forward(use_kernels=True)`` on the channel kind's encoder:
    a row's topic, image and text outputs alone have the bits of the same
    row among M (the first, the middle, the last)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from mmtg_tpu_torch.configs import ModelConfig
    from mmtg_tpu_torch.models.encoder import encoder_forward
    from mmtg_tpu_torch.params import _Init, tree_to

    mcfg = bi.channel_config(ModelConfig(), name)
    init = _Init(11)
    params = tree_to({"topic_fc": init.linear(mcfg.topic.input_dim, mcfg.topic.hidden_dim,
                                              xavier=True),
                      "image": init.channel(mcfg.image), "text": init.channel(mcfg.text)},
                     "cuda", dtype)
    gen = torch.Generator(device="cuda").manual_seed(12)
    E, S = mcfg.image.input_dim, mcfg.seq_len
    one = [torch.randn(*s, generator=gen, device="cuda").to(dtype)
           for s in ((1, E), (S, 1, E), (S, 1, E))]
    with torch.no_grad():
        alone = encoder_forward(params, mcfg, *one, use_kernels=True)
        for M in BATCHES[1:]:
            for row in sorted({0, M // 2, M - 1}):
                topic = torch.randn(M, E, generator=gen, device="cuda").to(dtype)
                img, txt = (torch.randn(S, M, E, generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                topic[row], img[:, row], txt[:, row] = one[0][0], one[1][:, 0], one[2][:, 0]
                got = encoder_forward(params, mcfg, topic, img, txt, use_kernels=True)
                assert torch.equal(got[0][:, row], alone[0][:, 0]), (M, row, "topic")
                assert torch.equal(got[1][:, row], alone[1][:, 0]), (M, row, "image")
                assert torch.equal(got[2][:, row], alone[2][:, 0]), (M, row, "text")
