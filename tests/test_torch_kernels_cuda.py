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
