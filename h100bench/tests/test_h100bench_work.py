"""The work counts against numbers worked by hand."""

import pytest
import torch

from h100bench import harness, work

ZH = harness.config("mmtg_zh")
EN = harness.config("mmtg_en")
PK = work.peaks("NVIDIA H100 80GB HBM3")


def test_peaks():
    assert PK == {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12}
    with pytest.raises(ValueError):
        work.peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("cfg,per_token", [
    # 12 (24 d^2 + 4 T d) + 2 d V + 2 (E 512 + 512 d), d 768, T 236
    (ZH, 12 * (24 * 768 ** 2 + 4 * 236 * 768) + 2 * 768 * 13317
     + 2 * (2048 * 512 + 512 * 768)),
    (EN, 12 * (24 * 768 ** 2 + 4 * 236 * 768) + 2 * 768 * 50257
     + 2 * (512 * 512 + 512 * 768)),
])
def test_train_flops(cfg, per_token):
    got = work.train_flops_model(cfg["model"], cfg["data"], 256)
    assert got == 3 * 256 * 236 * per_token
    if cfg is ZH:
        assert 36.5e12 < got < 36.7e12


def test_live_slots():
    """Prompt and [#START#] (16), then each target token that is not [PAD];
    the second row samples [PAD] at step 1."""
    toks = torch.tensor([[1, 5, 6, 7], [1, 5, 0, 0]])
    assert work.live_slots(toks, 15).tolist() == [17 + 17, 18 + 17, 19 + 17]


def test_decode_attention_least_one_step():
    m, d = ZH["model"], ZH["data"]
    B, n = 2, 40  # 20 live slots a row at step 0
    got = work.decode_attention_least(m, d, B, torch.tensor([n]), PK)
    D, pos = 768, 16
    nbytes = (B * D * 2 + 2 * n * D + 4 * B * (pos + 1) + B * D * 2 + 8 * n
              + 2 * B * D * 2 + 2 * B * D + 8 * B)
    assert got == pytest.approx(12 * max(nbytes / 3.35e12, 4 * n * D / 989e12))


def test_generate_products_a_step():
    """A decode step's products: the projector, four a layer, the LM head;
    2 x 768 x (12 x 12 x 768 + V) + 2 (2048 512 + 512 768) operations a
    row."""
    m, d = ZH["model"], ZH["data"]
    one = work.generate_products(m, d, 1, 1)
    none = work.generate_products(m, d, 1, 0)
    step = one[len(none):]
    assert len(step) == 2 + 4 * 12 + 1
    ops = sum(2 * Z * M * K * N for Z, M, K, N, _, _ in step)
    assert ops == 2 * 768 * (12 * 12 * 768 + 13317) + 2 * (2048 * 512 + 512 * 768)


def test_product_least():
    # [2048, 768] @ [768, 2304] + bias in bf16: bound by operations
    got = work.product_least([(1, 2048, 768, 2304, 2, True)], PK)
    assert got == pytest.approx(2 * 2048 * 768 * 2304 / 989e12)
    # a [1, 3] @ [3, 512] mix is bound by bytes
    got = work.product_least([(10, 1, 3, 512, 2, False)], PK)
    assert got == pytest.approx(10 * (3 + 1536 + 512) * 2 / 3.35e12)


def test_train_attention_least():
    m, d = ZH["model"], ZH["data"]
    B, T, D, H = 256, 236, 768, 12
    pairs = B * H * T * (T + 1) / 2
    fwd = B * T * 3 * D * 2 + 3 * D * 2 + B * T * 4 + B * T * D * 2 + B * H * T * 4
    bwd = fwd + B * T * D * 2 + B * T * 3 * D * 2 + 3 * D * 4
    want = 12 * (max(fwd / 3.35e12, 4 * 64 * pairs / 989e12)
                 + max(bwd / 3.35e12, 10 * 64 * pairs / 989e12))
    assert work.train_attention_least(m, d, B, PK) == pytest.approx(want)
