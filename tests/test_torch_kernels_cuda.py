"""The hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where PyTorch sees no CUDA device (the card-side
comparison at the decode path's full shapes is ``chip_smoke.py`` phase 2).
Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` (the
shared conftest imports jax, which such a machine need not have).
"""

import pytest
import torch

from mmtg_tpu_torch.ops import decode_attention as da
from mmtg_tpu_torch.ops import fused_gru as fg
from mmtg_tpu_torch.ops import train_attention as ta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("position", [0, 5, 63, 64, 200, 255])
def test_decode_attention_kernel_matches_plain(cuda, dtype, tol, int8, position):
    L, B, T, H, D = 3, 5, 256, 4, 128
    q, k_new, v_new = (torch.randn(B, D, generator=cuda, device="cuda").to(dtype)
                       for _ in range(3))
    mask = torch.randint(0, 2, (B, T), generator=cuda, device="cuda",
                         dtype=torch.int32)
    mask[:, 0] = 1
    if int8:
        base = [torch.randint(-127, 128, (L, B, T, D), generator=cuda,
                              device="cuda", dtype=torch.int8) for _ in range(2)]
        base += [torch.rand(L, B, T, generator=cuda, device="cuda") * 0.02 + 0.005
                 for _ in range(2)]
        kernel = da.decode_attention_int8_append
    else:
        base = [torch.randn(L, B, T, D, generator=cuda, device="cuda").to(dtype)
                for _ in range(2)]
        kernel = da.decode_attention_fp_append
    kc = [c.clone() for c in base]
    pc = [c.clone() for c in base]
    before = kernel.launches
    ctx = kernel(q, k_new, v_new, *kc, mask, position, 1, n_head=H)
    ref = da.decode_attention_append_plain(q, k_new, v_new, pc[0], pc[1], mask,
                                           position, 1, H, *pc[2:])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(kc, pc):
        assert torch.equal(a, b)
    assert (ctx.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B", [3, 8, 30])
def test_fused_gru_kernel_matches_plain(cuda, dtype, tol, B):
    T, I, H = 5, 96, 64
    x = torch.randn(T, B, I, generator=cuda, device="cuda").to(dtype)
    w_ih = (torch.randn(I, 3 * H, generator=cuda, device="cuda") * 0.1).to(dtype)
    w_hh = (torch.randn(H, 3 * H, generator=cuda, device="cuda") * 0.1).to(dtype)
    b_ih, b_hh = ((torch.randn(3 * H, generator=cuda, device="cuda") * 0.1).to(dtype)
                  for _ in range(2))
    out = fg.fused_gru(x, w_ih, w_hh, b_ih, b_hh)
    ref = fg.fused_gru_plain(x, w_ih, w_hh, b_ih, b_hh)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (T, B, H)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _train_attention_case(gen, B, T, H, hd, dtype):
    qkv = (torch.randn(B, T, 3 * H * hd, generator=gen, device="cuda") * 0.7).to(dtype)
    qb = (torch.randn(3 * H * hd, generator=gen, device="cuda") * 0.1).to(dtype)
    bias = torch.zeros(B, T, device="cuda")
    bias[:, T - 20:] = ta.NEG_INF  # a key-padding tail
    bias[0, 5:9] = ta.NEG_INF      # and a hole inside row 0
    co = torch.randn(B, T, H * hd, generator=gen, device="cuda").to(dtype)
    seed = torch.tensor([1234567], dtype=torch.int32, device="cuda")
    return qkv, qb, bias, co, seed


# f32: the two versions differ only in summation order (and dqb in the
# order of its atomic adds); bf16: one rounding of the working type on
# values of order 1 (ctx, dqkv) and on sums over B*T rows (dqb)
@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 3e-2, 0.5))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("H,hd,T", [(2, 64, 128), (3, 32, 256), (2, 128, 128),
                                    (2, 40, 128)])
def test_mha_train_packed_kernel_matches_plain(cuda, dtype, tols, rate, H, hd, T):
    B = 3
    qkv, qb, bias, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    scale = hd ** -0.5
    grads = []
    for fn in (ta.mha_train_packed, ta.mha_train_packed_plain):
        a = qkv.clone().requires_grad_(True)
        b = qb.clone().requires_grad_(True)
        fwd0, bwd0 = ta.mha_train_packed.fwd_launches, ta.mha_train_packed.bwd_launches
        ctx = fn(a, b, bias, seed, H, rate, scale)
        da_, db_ = torch.autograd.grad((ctx.float() * co.float()).sum(), (a, b))
        torch.cuda.synchronize()
        launched = (ta.mha_train_packed.fwd_launches - fwd0,
                    ta.mha_train_packed.bwd_launches - bwd0)
        assert launched == ((1, 1) if fn is ta.mha_train_packed else (0, 0))
        grads.append((ctx, da_, db_))
    for got, ref, tol in zip(grads[0], grads[1], tols):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        assert (got.float() - ref.float()).abs().max().item() <= tol


def test_mha_train_packed_dqkv_is_reproducible(cuda):
    qkv, qb, bias, co, seed = _train_attention_case(cuda, 2, 128, 2, 64,
                                                    torch.bfloat16)
    runs = []
    for _ in range(2):
        a = qkv.clone().requires_grad_(True)
        ctx = ta.mha_train_packed(a, qb, bias, seed, 2, 0.1, 0.125)
        runs.append((ctx, torch.autograd.grad((ctx * co).sum(), a)[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_mha_train_packed_rejects_bad_input(cuda):
    qkv = torch.zeros(1, 128, 3 * 2 * 64, device="cuda")
    qb = torch.zeros(3 * 2 * 64, device="cuda")
    bias = torch.zeros(1, 128, device="cuda")
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # T not a multiple of 128
        ta.mha_train_packed(qkv[:, :100].contiguous(), qb, bias[:, :100].contiguous(),
                            seed, 2)
    with pytest.raises(ValueError):  # head_dim 136 > 128
        ta.mha_train_packed(torch.zeros(1, 128, 3 * 136, device="cuda"),
                            torch.zeros(3 * 136, device="cuda"), bias, seed, 1)
    with pytest.raises(TypeError):
        ta.mha_train_packed(qkv.half(), qb.half(), bias, seed, 2)
    with pytest.raises(ValueError):  # seed on another device
        ta.mha_train_packed(qkv, qb, bias, seed.cpu(), 2)


def test_wrapper_rejects_bad_input(cuda):
    q = torch.randn(2, 64, device="cuda")
    cache = torch.zeros(1, 2, 16, 64, device="cuda")
    mask = torch.ones(2, 16, dtype=torch.int32, device="cuda")
    with pytest.raises(IndexError):
        da.decode_attention_fp_append(q, q, q, cache, cache.clone(), mask, 16, 0,
                                      n_head=2)
    with pytest.raises(TypeError):
        da.decode_attention_fp_append(q, q, q, cache.half(), cache.half(), mask,
                                      3, 0, n_head=2)
