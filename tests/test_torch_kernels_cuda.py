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
# values of order 1 (ctx: the tensor-core forward rounds the un-normalised
# probabilities, the plain version the normalised ones; dqkv) and on sums
# over B*T rows (dqb)
@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 3e-2, 0.5))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("H,hd,T", [(2, 64, 128), (3, 32, 256), (2, 128, 128),
                                    (2, 40, 128), (2, 64, 384), (2, 64, 512),
                                    (2, 128, 512), (2, 8, 256), (3, 40, 384),
                                    (2, 8, 512), (1, 104, 256)])
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


def _segment_ids(gen, B, T, kind):
    if kind == "random":  # arbitrary ids in no order: equality is all that counts
        return torch.randint(0, 4, (B, T), generator=gen, device="cuda",
                             dtype=torch.int32)
    # as a packer writes them: ascending ids, then the pad slots' own segment
    seg = torch.full((B, T), 2 ** 15, dtype=torch.int32, device="cuda")
    for b in range(B):
        cuts = sorted(torch.randint(1, T - 10, (3,), generator=gen, device="cuda").tolist())
        for s, (lo, hi) in enumerate(zip([0] + cuts[:-1], cuts)):
            seg[b, lo:hi] = s
    return seg


def _compare(fn, plain, args, co, tols, expect_launch=True):
    """Forward and gradients of ``fn`` (the kernels) vs ``plain`` on the same
    inputs; ``args`` = (qkv, qb, mask, seed, H, rate, scale)."""
    qkv, qb = args[:2]
    results = []
    for f in (fn, plain):
        a = qkv.clone().requires_grad_(True)
        b = qb.clone().requires_grad_(True)
        fwd0, bwd0 = fn.fwd_launches, fn.bwd_launches
        ctx = f(a, b, *args[2:])
        da_, db_ = torch.autograd.grad((ctx.float() * co.float()).sum(), (a, b))
        torch.cuda.synchronize()
        launched = (fn.fwd_launches - fwd0, fn.bwd_launches - bwd0)
        assert launched == ((1, 1) if f is fn else (0, 0))
        results.append((ctx, da_, db_))
    for got, ref, tol in zip(results[0], results[1], tols):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        assert (got.float() - ref.float()).abs().max().item() <= tol
    return results


@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 3e-2, 0.5))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["random", "packer"])
@pytest.mark.parametrize("hd", [8, 32, 40, 64, 128])
@pytest.mark.parametrize("T", [128, 256, 384, 512])
def test_mha_train_packed_seg_kernel_matches_plain(cuda, dtype, tols, rate, kind, hd, T):
    B, H = 2, 2
    qkv, qb, _, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    seg = _segment_ids(cuda, B, T, kind)
    before = (ta.mha_train_packed.fwd_launches, ta.mha_train.fwd_launches)
    _compare(ta.mha_train_packed_seg, ta.mha_train_packed_seg_plain,
             (qkv, qb, seg, seed, H, rate, hd ** -0.5), co, tols)
    # each function counts its own launches
    assert before == (ta.mha_train_packed.fwd_launches, ta.mha_train.fwd_launches)


def _pad_heads(t, H, hd):
    """``[..., 3*H*hd]`` standard order -> ``[..., H*384]`` head-major, zero pad."""
    x = torch.nn.functional.pad(t.reshape(t.shape[:-1] + (3, H, hd)), (0, 128 - hd))
    return x.transpose(-3, -2).reshape(t.shape[:-1] + (H * 384,)).contiguous()


@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 3e-2, 0.5))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hd", [8, 32, 40, 64, 128])
@pytest.mark.parametrize("T", [128, 256, 384, 512])
def test_mha_train_kernel_matches_plain(cuda, dtype, tols, rate, hd, T):
    B, H = 2, 3
    qkv, qb, bias, _, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    slab, slab_b = _pad_heads(qkv, H, hd), _pad_heads(qb, H, hd)
    co = torch.randn(B, T, H, 128, generator=cuda, device="cuda")
    co[..., hd:] = 0.0  # as the padded output projection hands it back
    co = co.reshape(B, T, H * 128).to(dtype)
    (ctx, dqkv, dqb), _ = _compare(ta.mha_train, ta.mha_train_plain,
                                   (slab, slab_b, bias, seed, H, rate, hd ** -0.5),
                                   co, tols)
    assert ctx.shape == (B, T, H * 128) and dqkv.shape == slab.shape
    # every element is written, pad lanes too: zero where the inputs' are zero
    assert hd == 128 or ctx.view(B, T, H, 128)[..., hd:].abs().max().item() == 0.0
    assert hd == 128 or dqkv.view(B, T, H, 3, 128)[..., hd:].abs().max().item() == 0.0
    assert hd == 128 or dqb.view(H, 3, 128)[..., hd:].abs().max().item() == 0.0
    # and the live lanes are the standard-slab kernel's numbers
    ref = ta.mha_train_packed(qkv, qb, bias, seed, H, rate, hd ** -0.5)
    torch.cuda.synchronize()
    live = ctx.view(B, T, H, 128)[..., :hd].reshape(B, T, H * hd)
    assert (live.float() - ref.float()).abs().max().item() <= tols[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_train_packed_dqkv_is_reproducible(cuda, dtype):
    qkv, qb, bias, co, seed = _train_attention_case(cuda, 2, 128, 2, 64, dtype)
    runs = []
    for _ in range(2):
        a = qkv.clone().requires_grad_(True)
        ctx = ta.mha_train_packed(a, qb, bias, seed, 2, 0.1, 0.125)
        runs.append((ctx, torch.autograd.grad((ctx * co).sum(), a)[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["mha_train_packed_seg", "mha_train"])
def test_new_kernels_dqkv_is_reproducible(cuda, fn, dtype):
    B, T, H, hd = 2, 256, 2, 64
    qkv, qb, bias, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    if fn == "mha_train":
        qkv, qb = _pad_heads(qkv, H, hd), _pad_heads(qb, H, hd)
        co = torch.randn(B, T, H * 128, generator=cuda, device="cuda").to(dtype)
        mask = bias
    else:
        mask = _segment_ids(cuda, B, T, "packer")
    runs = []
    for _ in range(2):
        a = qkv.clone().requires_grad_(True)
        ctx = getattr(ta, fn)(a, qb, mask, seed, H, 0.1, 0.125)
        runs.append((ctx, torch.autograd.grad((ctx * co).sum(), a)[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_new_kernels_reject_bad_input(cuda):
    qkv = torch.zeros(1, 128, 3 * 2 * 64, device="cuda")
    qb = torch.zeros(3 * 2 * 64, device="cuda")
    seg = torch.zeros(1, 128, dtype=torch.int32, device="cuda")
    seed = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):  # a float mask where segment ids belong
        ta.mha_train_packed_seg(qkv, qb, seg.float(), seed, 2)
    with pytest.raises(TypeError):  # int64 ids
        ta.mha_train_packed_seg(qkv, qb, seg.long(), seed, 2)
    with pytest.raises(ValueError):  # T = 1152 > 1024
        ta.mha_train_packed_seg(torch.zeros(1, 1152, 384, device="cuda"), qb,
                                torch.zeros(1, 1152, dtype=torch.int32, device="cuda"),
                                seed, 2)
    with pytest.raises(ValueError):  # not a head-major slab
        ta.mha_train(qkv, qb, seg.float(), seed, 2)
    with pytest.raises(TypeError):  # bias of the standard order's length
        ta.mha_train(torch.zeros(1, 128, 2 * 384, device="cuda"), qb, seg.float(),
                     seed, 2)


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
    # a bf16 view that starts 8 bytes off a 16-byte boundary
    flat = torch.zeros(128 * 384 + 4, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.mha_train_packed(flat[4:].view(1, 128, 384), qb.bfloat16(), bias, seed, 2)


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


# ---- the serving decode path's kernels --------------------------------------

DECODE_POSITIONS = [0, 5, 63, 64, 200, 255]
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _decode_case(gen, kind, dtype, B, H, hd, L=3, T=256):
    """q, k_new, v_new, a key mask with holes, and a cache of ``kind`` filled
    everywhere (so whatever lies beyond ``position`` is garbage): returns
    (q, k_new, v_new, mask, [k, v] or [kv], [k_scale, v_scale] or [])."""
    D = H * hd
    q, k_new, v_new = (torch.randn(B, D, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
    mask = torch.randint(0, 2, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)
    mask[:, 0] = 1
    if kind == "fp":
        return q, k_new, v_new, mask, [
            torch.randn(L, B, T, D, generator=gen, device="cuda").to(dtype)
            for _ in range(2)], []
    row = {"int8": D, "int4": D // 2, "merged": 2 * D}[kind]
    caches = [torch.randint(-127, 128, (L, B, T, row), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(1 if kind == "merged" else 2)]
    scales = [torch.rand(L, B, T, generator=gen, device="cuda") * 0.02 + 0.005
              for _ in range(2)]
    return q, k_new, v_new, mask, caches, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("B,H,hd", [(1, 4, 32), (3, 2, 64), (64, 2, 128), (3, 3, 32)])
@pytest.mark.parametrize("position", DECODE_POSITIONS)
def test_decode_attention_readonly_kernel_matches_plain(cuda, dtype, kind, B, H, hd,
                                                        position):
    q, _, _, mask, caches, scales = _decode_case(cuda, kind, dtype, B, H, hd)
    kernel = {"fp": da.decode_attention, "int8": da.decode_attention_int8,
              "int4": da.decode_attention_int4}[kind]
    keep = [c.clone() for c in caches + scales]
    before = kernel.launches
    ctx = kernel(q, *caches, *scales, mask, position, 1, n_head=H)
    ref = da.decode_attention_plain(q, *caches, mask, position, 1, H, *scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(caches + scales, keep):  # nothing was written
        assert torch.equal(a, b)
    assert (ctx.float() - ref.float()).abs().max().item() <= DECODE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int4", "merged"])
@pytest.mark.parametrize("B,H,hd", [(1, 4, 32), (3, 2, 64), (64, 2, 128), (3, 3, 32)])
@pytest.mark.parametrize("position", DECODE_POSITIONS)
def test_decode_attention_int4_and_merged_append_match_plain(cuda, dtype, kind, B, H,
                                                             hd, position):
    q, k_new, v_new, mask, caches, scales = _decode_case(cuda, kind, dtype, B, H, hd)
    kernel = (da.decode_attention_int4_append if kind == "int4"
              else da.decode_attention_int8_append_merged)
    kc = [c.clone() for c in caches + scales]
    pc = [c.clone() for c in caches + scales]
    before = kernel.launches
    ctx = kernel(q, k_new, v_new, *kc, mask, position, 1, n_head=H)
    ref = da.decode_attention_append_plain(
        q, k_new, v_new, pc[0], None if kind == "merged" else pc[1], mask,
        position, 1, H, *pc[-2:])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(kc, pc):  # appended bytes and scales bit for bit
        assert torch.equal(a, b)
    assert (ctx.float() - ref.float()).abs().max().item() <= DECODE_TOL[dtype]
    # the read-only kernel on the cache just written gives the same context
    if kind == "int4":
        again = da.decode_attention_int4(q, *kc, mask, position, 1, n_head=H)
    else:
        D = H * hd
        again = da.decode_attention_int8(
            q, kc[0][..., :D].contiguous(), kc[0][..., D:].contiguous(), *kc[1:],
            mask, position, 1, n_head=H)
    assert torch.equal(again, ctx)


def test_merged_append_equals_split_append(cuda):
    B, H, hd, pos = 5, 4, 64, 77
    D = H * hd
    q, k_new, v_new, mask, (kv,), scales = _decode_case(cuda, "merged",
                                                       torch.bfloat16, B, H, hd)
    k, v = kv[..., :D].contiguous(), kv[..., D:].contiguous()
    s1, s2 = [s.clone() for s in scales], [s.clone() for s in scales]
    a = da.decode_attention_int8_append_merged(q, k_new, v_new, kv, *s1, mask, pos, 2,
                                               n_head=H)
    b = da.decode_attention_int8_append(q, k_new, v_new, k, v, *s2, mask, pos, 2,
                                        n_head=H)
    assert torch.equal(a, b)
    assert torch.equal(kv[..., :D], k) and torch.equal(kv[..., D:], v)
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))


def _fused_case(gen, dtype, B, H, hd, L=3, T=256):
    from mmtg_tpu_torch.configs import GPT2Config
    from mmtg_tpu_torch.params import init_gpt2_params

    D = H * hd
    cfg = GPT2Config(vocab_size=120, n_positions=300, n_ctx=300, n_embd=D,
                     n_layer=L, n_head=H)
    p = init_gpt2_params(cfg, seed=0, dtype=dtype, device="cuda")["h"]
    # biases and gains off their init values, so that each matters
    p = {k: (v + 0.05 * torch.randn(v.shape, generator=gen, device="cuda").to(dtype)
             if v.dim() == 2 else v) for k, v in p.items()}
    h = (torch.randn(B, D, generator=gen, device="cuda") * 0.5).to(dtype)
    _, _, _, mask, caches, scales = _decode_case(gen, "int8", dtype, B, H, hd, L, T)
    return p, h, mask, caches + scales


# f32: the hand-written products sum in another order than torch.matmul, so a
# k/v entry differs in its last bits and a code may differ by 1, which moves a
# context entry by one quantization step (1/127 of the row's largest entry);
# bf16: one rounding of the stream type (2^-8 relative) per product, through L
# layers; there a k/v entry may differ by one bf16 step (half a code at the
# row's maximum) and the row maximum that sets the scale by another
FUSED_TOL = {torch.float32: 5e-3, torch.bfloat16: 1.5e-1}
FUSED_CODES = {torch.float32: 1, torch.bfloat16: 2}
# scales, relative: layer 0's (from the inputs alone) and, at narrow widths,
# every layer's; at the model's width (D = 768: 12 heads of 64) a later layer's
# scale inherits h's difference through the codes flipped on a rounding
# boundary in the layers before it. On an H100, at B = 512, D = 768, the
# largest such gap was 1.88e-4 in f32 and 1.18e-2 in bf16, the same for this
# kernel and for the one-block-a-row design before it; the wide limits sit
# just above those readings.
FUSED_SCALE = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FUSED_SCALE_WIDE = {torch.float32: 5e-4, torch.bfloat16: 1.5e-2}


def _check_fused(p, h, mask, state, position, H):
    """One whole-step call against its plain version: h within FUSED_TOL, the
    appended codes within FUSED_CODES, the scales as stated, one launch, and
    no slot but `position` written."""
    from mmtg_tpu_torch.ops import decode_megakernel as mk

    dtype = h.dtype
    kc = [c.clone() for c in state]
    pc = [c.clone() for c in state]
    before = mk.decode_block_fused.launches
    out = mk.decode_block_fused(h, p, *kc, mask, position, n_head=H)
    ref = mk.decode_block_fused_plain(h, p, *pc, mask, position, n_head=H)
    torch.cuda.synchronize()
    assert mk.decode_block_fused.launches == before + 1
    assert out.shape == h.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= FUSED_TOL[dtype]
    for got, want, orig in zip(kc[:2], pc[:2], state[:2]):
        # codes within the stated distance, and only slot `position` was written
        assert (got.int() - want.int()).abs().max().item() <= FUSED_CODES[dtype]
        assert torch.equal(got[:, :, position + 1:], orig[:, :, position + 1:])
        assert torch.equal(got[:, :, :position], orig[:, :, :position])
    later = FUSED_SCALE_WIDE[dtype] if h.shape[1] >= 768 else FUSED_SCALE[dtype]
    for got, want, orig in zip(kc[2:], pc[2:], state[2:]):
        torch.testing.assert_close(got[:1], want[:1], rtol=FUSED_SCALE[dtype], atol=0)
        torch.testing.assert_close(got[1:], want[1:], rtol=later, atol=0)
        assert torch.equal(got[:, :, position + 1:], orig[:, :, position + 1:])
        assert torch.equal(got[:, :, :position], orig[:, :, :position])
    return out, kc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hd", [(1, 4, 32), (3, 2, 64), (8, 12, 64), (64, 2, 128),
                                    (136, 4, 32), (272, 4, 32), (512, 12, 64)])
@pytest.mark.parametrize("position", [0, 63, 64, 235, 255])
def test_decode_block_fused_kernel_matches_plain(cuda, dtype, B, H, hd, position):
    """B = 1, 3 (ragged batch tiles), 8, 64, 136 and 272 (more rows than one
    staged group of 64), 512; H = 2, 4, 12; split-K where the plan splits."""
    p, h, mask, state = _fused_case(cuda, dtype, B, H, hd)
    _check_fused(p, h, mask, state, position, H)


def test_decode_block_fused_is_reproducible(cuda):
    from mmtg_tpu_torch.ops import decode_megakernel as mk

    p, h, mask, state = _fused_case(cuda, torch.bfloat16, 5, 4, 32)
    outs = []
    for _ in range(2):
        c = [s.clone() for s in state]
        outs.append((mk.decode_block_fused(h, p, *c, mask, 100, n_head=4), c))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("B", [64, 512])
def test_decode_block_fused_is_reproducible_at_width(cuda, B):
    """At the model's 12 heads of 64 lanes (the plan splits K there): two
    calls give the same bits in h, the caches and the scales."""
    from mmtg_tpu_torch.ops import decode_megakernel as mk

    p, h, mask, state = _fused_case(cuda, torch.bfloat16, B, 12, 64)
    pl = mk.plan(B, 768, 3, 256, 12, torch.bfloat16,
                 torch.cuda.get_device_properties(0).multi_processor_count)
    assert any(q.splits > 1 for q in pl.products)
    outs = []
    for _ in range(2):
        c = [s.clone() for s in state]
        outs.append((mk.decode_block_fused(h, p, *c, mask, 235, n_head=12), c))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_decode_block_fused_batch_changes_between_calls(cuda):
    """64 -> 1 -> 512 rows on one stream: the barrier words and the column
    counts each call leaves serve the next, whatever its grid and split."""
    for dtype in (torch.float32, torch.bfloat16):
        for B in (64, 1, 512):
            p, h, mask, state = _fused_case(cuda, dtype, B, 12, 64)
            _check_fused(p, h, mask, state, 235, 12)


def test_decode_block_fused_raises_for_a_grid_it_cannot_place(cuda, monkeypatch):
    """A plan of 8 blocks an SM cannot be resident at once (each block needs
    more than 32 registers a thread): the wrapper raises, nothing launches."""
    from mmtg_tpu_torch.ops import decode_megakernel as mk

    p, h, mask, state = _fused_case(cuda, torch.bfloat16, 3, 4, 32)
    monkeypatch.setattr(mk, "BLOCKS_PER_SM", (8,))
    before = mk.decode_block_fused.launches
    with pytest.raises(RuntimeError, match="cannot hold"):
        mk.decode_block_fused(h, p, *state, mask, 5, n_head=4)
    assert mk.decode_block_fused.launches == before


def test_new_decode_wrappers_reject_bad_input(cuda):
    from mmtg_tpu_torch.ops import decode_megakernel as mk

    q, k_new, v_new, mask, caches, scales = _decode_case(cuda, "int4", torch.float32,
                                                         2, 2, 32)
    with pytest.raises(ValueError):  # an int4 cache handed to the int8 kernel
        da.decode_attention_int8_append(q, k_new, v_new, *caches, *scales, mask, 3, 0,
                                        n_head=2)
    with pytest.raises(ValueError):  # and to the whole-step kernel
        p, h, m, _ = _fused_case(cuda, torch.float32, 2, 2, 32)
        mk.decode_block_fused(h, p, *caches, *scales, m, 3, n_head=2)
    p, h, m, state = _fused_case(cuda, torch.float32, 2, 2, 32)
    with pytest.raises(TypeError):  # weights of another dtype than the stream
        mk.decode_block_fused(h.bfloat16(), p, *state, m, 3, n_head=2)
    with pytest.raises(IndexError):
        mk.decode_block_fused(h, p, *state, m, 256, n_head=2)


# ---- the regimes of the redesigned kernels ------------------------------------

SWEEP_POSITIONS = [0, 15, 16, 127, 128, 235, 255]  # 255 = T - 1
SWEEP_WRAPPERS = [("decode_attention_fp_append", "fp", True),
                  ("decode_attention_int8_append", "int8", True),
                  ("decode_attention_int4_append", "int4", True),
                  ("decode_attention_int8_append_merged", "merged", True),
                  ("decode_attention", "fp", False),
                  ("decode_attention_int8", "int8", False),
                  ("decode_attention_int4", "int4", False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,kind,append", SWEEP_WRAPPERS,
                         ids=[w[0] for w in SWEEP_WRAPPERS])
@pytest.mark.parametrize("B,H,hd", [(1, 12, 64), (3, 3, 32), (3, 2, 64), (64, 12, 64),
                                    (512, 12, 64)])
def test_decode_attention_sweep(cuda, dtype, name, kind, append, B, H, hd):
    """Every wrapper at B = 1 (the slots split into chunks), 3, 64 and 512 (one
    chunk), H = 2, 3 (int4: D/2 inside a head), 12: ctx within tolerance of the
    plain version, the appended bytes and scales bit for bit, nothing else
    written, and after an append the read-only kernel gives the same ctx."""
    kernel = getattr(da, name)
    q, k_new, v_new, mask, caches, scales = _decode_case(cuda, kind, dtype, B, H, hd, L=2)
    base = caches + scales
    n = len(caches)
    pair = kind == "int4" and da.int4_pairs(H, hd)
    splits = {da.split_slots(B * H // (2 if pair else 1), p)[0] for p in SWEEP_POSITIONS}
    assert (max(splits) > 1) == (B * H < 264)  # both regimes are reached
    for position in SWEEP_POSITIONS:
        kc = [c.clone() for c in base]
        pc = [c.clone() for c in base]
        new = (k_new, v_new) if append else ()
        before = kernel.launches
        ctx = kernel(q, *new, *kc, mask, position, 1, n_head=H)
        if append:
            ref = da.decode_attention_append_plain(
                q, k_new, v_new, pc[0], None if kind == "merged" else pc[1], mask,
                position, 1, H, *pc[n:])
        else:
            ref = da.decode_attention_plain(q, *pc[:n], mask, position, 1, H, *pc[n:])
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for a, b, orig in zip(kc, pc, base):
            assert torch.equal(a, b), f"position {position}: cache or scales differ"
            if not append:
                assert torch.equal(a, orig)
        err = (ctx.float() - ref.float()).abs().max().item()
        assert err <= DECODE_TOL[dtype], f"position {position}: ctx max-abs {err:.3g}"
        if append:
            if kind == "merged":
                D = H * hd
                again = da.decode_attention_int8(q, kc[0][..., :D].contiguous(),
                                                 kc[0][..., D:].contiguous(), *kc[1:],
                                                 mask, position, 1, n_head=H)
            else:
                read = {"fp": da.decode_attention, "int8": da.decode_attention_int8,
                        "int4": da.decode_attention_int4}[kind]
                again = read(q, *kc, mask, position, 1, n_head=H)
            assert torch.equal(again, ctx), f"position {position}: read-only differs"
        del kc, pc


def test_decode_attention_split_is_reproducible(cuda):
    """The chunks of a split call merge in chunk order, whichever finishes
    last: two calls give the same bits, and the counts they leave are zero."""
    q, _, _, mask, caches, scales = _decode_case(cuda, "int8", torch.bfloat16, 1, 12, 64)
    outs = [da.decode_attention_int8(q, *caches, *scales, mask, 235, 1, n_head=12)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert all(int(buf.abs().sum()) == 0 for buf in da._counters.values())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H", [64, 96, 512])
@pytest.mark.parametrize("B", [1, 3, 64, 512])
def test_fused_gru_sweep(cuda, dtype, tol, H, B):
    """The cluster kernel at H = 64, 96 (clusters of 2 and 3 blocks) and 512
    (16 blocks, non-portable), B from one row group to many per cluster: one
    launch a call, within tolerance of the plain version."""
    T, I = 5, 128
    x = torch.randn(T, B, I, generator=cuda, device="cuda").to(dtype)
    w_ih = (torch.randn(I, 3 * H, generator=cuda, device="cuda") * I ** -0.5).to(dtype)
    w_hh = (torch.randn(H, 3 * H, generator=cuda, device="cuda") * H ** -0.5).to(dtype)
    b_ih, b_hh = ((torch.randn(3 * H, generator=cuda, device="cuda") * 0.1).to(dtype)
                  for _ in range(2))
    before = fg.fused_gru.launches
    out = fg.fused_gru(x, w_ih, w_hh, b_ih, b_hh)
    ref = fg.fused_gru_plain(x, w_ih, w_hh, b_ih, b_hh)
    torch.cuda.synchronize()
    assert fg.fused_gru.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, B, H)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_fused_gru_rejects_hidden_sizes_it_cannot_split(cuda):
    x = torch.zeros(5, 2, 8, device="cuda")
    for H in (48, 544):
        with pytest.raises(ValueError):
            fg.fused_gru(x, torch.zeros(8, 3 * H, device="cuda"),
                         torch.zeros(H, 3 * H, device="cuda"),
                         torch.zeros(3 * H, device="cuda"), torch.zeros(3 * H, device="cuda"))


# rows longer than 512: bf16 dk/dv sum over up to T queries, so at T = 1024 a
# dqkv entry passes 8 where one bf16 rounding is 0.0625 (as chip_smoke.SEG_TOL)
LONG_TOLS = {torch.float32: (1e-5, 1e-5, 1e-4), torch.bfloat16: (2e-2, 8e-2, 0.5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [640, 768, 1024])
@pytest.mark.parametrize("fn", ["mha_train_packed", "mha_train_packed_seg", "mha_train"])
def test_train_attention_rows_over_512(cuda, fn, dtype, T):
    """#7, #8 and #9 at row lengths 640-1024 (the f32 forward takes its keys in
    chunks of 512 there), dropout on, against their plain versions."""
    B, H, hd = 2, 2, 64
    qkv, qb, bias, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    f = getattr(ta, fn)
    if fn == "mha_train_packed_seg":
        args = (qkv, qb, _segment_ids(cuda, B, T, "packer"), seed, H, 0.1, hd ** -0.5)
    elif fn == "mha_train":
        co = torch.randn(B, T, H, 128, generator=cuda, device="cuda")
        co[..., hd:] = 0.0
        co = co.reshape(B, T, H * 128).to(dtype)
        args = (_pad_heads(qkv, H, hd), _pad_heads(qb, H, hd), bias, seed, H, 0.1,
                hd ** -0.5)
    else:
        args = (qkv, qb, bias, seed, H, 0.1, hd ** -0.5)
    _compare(f, f.plain, args, co, LONG_TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_attention_long_rows_dqkv_is_reproducible(cuda, dtype):
    qkv, qb, bias, co, seed = _train_attention_case(cuda, 1, 1024, 2, 64, dtype)
    runs = []
    for _ in range(2):
        a = qkv.clone().requires_grad_(True)
        ctx = ta.mha_train_packed(a, qb, bias, seed, 2, 0.1, 0.125)
        runs.append((ctx, torch.autograd.grad((ctx * co).sum(), a)[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B", [1, 64])
def test_fused_gru_at_the_english_input_width(cuda, dtype, tol, B):
    """The English variant's channels: CLIP input width 512, H=512 (the
    input projection is outside the kernel, which checks only H)."""
    T, I, H = 5, 512, 512
    x = torch.randn(T, B, I, generator=cuda, device="cuda").to(dtype)
    w_ih = (torch.randn(I, 3 * H, generator=cuda, device="cuda") * I ** -0.5).to(dtype)
    w_hh = (torch.randn(H, 3 * H, generator=cuda, device="cuda") * H ** -0.5).to(dtype)
    b_ih, b_hh = ((torch.randn(3 * H, generator=cuda, device="cuda") * 0.1).to(dtype)
                  for _ in range(2))
    before = fg.fused_gru.launches
    out = fg.fused_gru(x, w_ih, w_hh, b_ih, b_hh)
    ref = fg.fused_gru_plain(x, w_ih, w_hh, b_ih, b_hh)
    torch.cuda.synchronize()
    assert fg.fused_gru.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, B, H)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T_real", [16, 17, 100, 127, 128, 129, 200, 236, 237])
def test_mha_train_packed_forward_over_infer_prefixes(cuda, dtype, tol, T_real):
    """mmtg_forward_infer's shapes: the topic prompt plus a target prefix of
    any length (16..237 tokens), padded to a multiple of 128 with -1e30 key
    bias on the pad; forward only (no gradient), 12 heads of 64, no
    dropout: one forward launch, the real rows within tolerance of the plain
    version."""
    B, H, hd = 2, 12, 64
    Tp = (T_real + 127) // 128 * 128
    qkv, qb, _, _, seed = _train_attention_case(cuda, B, Tp, H, hd, dtype)
    bias = torch.zeros(B, Tp, device="cuda")
    bias[:, T_real:] = ta.NEG_INF
    bias[1, 3:5] = ta.NEG_INF  # PAD slots inside a topic prompt
    before = (ta.mha_train_packed.fwd_launches, ta.mha_train_packed.bwd_launches)
    with torch.no_grad():
        out = ta.mha_train_packed(qkv, qb, bias, seed, H, 0.0, hd ** -0.5)
        ref = ta.mha_train_packed_plain(qkv, qb, bias, seed, H, 0.0, hd ** -0.5)
    torch.cuda.synchronize()
    assert (ta.mha_train_packed.fwd_launches, ta.mha_train_packed.bwd_launches) == (
        before[0] + 1, before[1])
    assert out.dtype == dtype and out.shape == (B, Tp, H * hd)
    assert (out[:, :T_real].float() - ref[:, :T_real].float()).abs().max().item() <= tol


@pytest.mark.parametrize("scheme", ["train", "reference_infer"])
def test_mmtg_forward_infer_kernel_matches_plain(cuda, scheme):
    """The no-cache inference forward on the card at a small size (2 layers,
    2 heads of 64), f32: the train-attention kernel's forward and its plain
    version give the same logits."""
    from mmtg_tpu_torch.configs import ChannelConfig, DataConfig, GPT2Config, ModelConfig
    from mmtg_tpu_torch.models.mmtg import mmtg_forward_infer
    from mmtg_tpu_torch.params import init_params

    mcfg = ModelConfig(
        topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32, type="LSTM"),
        text=ChannelConfig(input_dim=64, hidden_dim=32, type="TRM"),
        self_att_hidden_size=32, self_att_heads=4, mm_att_out_dim=64,
        gpt2=GPT2Config(vocab_size=300, n_positions=256, n_ctx=250, n_embd=128,
                        n_layer=2, n_head=2))
    dcfg = DataConfig(wenlan_emb_size=64)
    params = init_params(mcfg, seed=0, device="cuda")
    g = cuda
    B, K = 3, 150
    batch = {
        "topic_ids": torch.randint(103, 300, (B, 15), generator=g, device="cuda"),
        "tpw_attention_mask": torch.ones(B, 15, dtype=torch.int32, device="cuda"),
        "tpw_type_ids": torch.ones(B, 15, dtype=torch.int32, device="cuda"),
        "topic_emb": torch.randn(B, 64, generator=g, device="cuda"),
        "img_embs": torch.randn(B, 5, 64, generator=g, device="cuda"),
        "r_embs": torch.randn(B, 5, 64, generator=g, device="cuda"),
        "targets": torch.randint(103, 300, (B, K), generator=g, device="cuda"),
    }
    batch["targets"][1, 100:] = 0  # a row padded early
    table = {"wenlan_table": torch.randn(300, 64, generator=g, device="cuda")}
    before = ta.mha_train_packed.fwd_launches
    a = mmtg_forward_infer(params, table, mcfg, dcfg, batch, scheme)
    assert ta.mha_train_packed.fwd_launches == before + mcfg.gpt2.n_layer
    b = mmtg_forward_infer(params, table, mcfg, dcfg, batch, scheme, attn_impl="plain")
    torch.cuda.synchronize()
    assert ta.mha_train_packed.fwd_launches == before + mcfg.gpt2.n_layer
    assert a.logits.shape == (B, 15 + K, 300)
    assert (a.logits - b.logits).abs().max().item() <= 1e-4


# The sharded decode's shapes: a tensor-parallel rank holds 12/tp heads of 64
# lanes (tp = 2: 6 heads, D 384; tp = 4: 3 heads, D 192 — an odd head count
# leaves the int4 head-pair route) and B/dp rows of the batch.
SHARD_HEADS = [6, 3]
SHARD_ROWS = [32, 16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("H", SHARD_HEADS)
@pytest.mark.parametrize("B", SHARD_ROWS)
@pytest.mark.parametrize("position", [0, 64, 235])
def test_append_kernels_at_the_shard_shapes(cuda, dtype, kind, H, B, position):
    q, k_new, v_new, mask, caches, scales = _decode_case(cuda, kind, dtype, B, H, 64,
                                                         L=12)
    kernel = {"fp": da.decode_attention_fp_append,
              "int8": da.decode_attention_int8_append,
              "int4": da.decode_attention_int4_append}[kind]
    kc = [c.clone() for c in caches + scales]
    pc = [c.clone() for c in caches + scales]
    before = kernel.launches
    ctx = kernel(q, k_new, v_new, *kc, mask, position, 7, n_head=H)
    ref = da.decode_attention_append_plain(q, k_new, v_new, pc[0], pc[1], mask,
                                           position, 7, H, *pc[2:])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(kc, pc):  # appended bytes and scales bit for bit
        assert torch.equal(a, b)
    assert (ctx.float() - ref.float()).abs().max().item() <= DECODE_TOL[dtype]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B", SHARD_ROWS)
def test_fused_gru_at_the_shard_rows(cuda, dtype, tol, B):
    """The encoder's GRU (in 2048, H 512) on a data shard's B/dp rows."""
    T, I, H = 5, 2048, 512
    x = torch.randn(T, B, I, generator=cuda, device="cuda").to(dtype)
    w_ih = (torch.randn(I, 3 * H, generator=cuda, device="cuda") * 0.02).to(dtype)
    w_hh = (torch.randn(H, 3 * H, generator=cuda, device="cuda") * 0.05).to(dtype)
    b_ih, b_hh = ((torch.randn(3 * H, generator=cuda, device="cuda") * 0.05).to(dtype)
                  for _ in range(2))
    before = fg.fused_gru.launches
    out = fg.fused_gru(x, w_ih, w_hh, b_ih, b_hh)
    ref = fg.fused_gru_plain(x, w_ih, w_hh, b_ih, b_hh)
    torch.cuda.synchronize()
    assert fg.fused_gru.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, B, H)
    assert (out.float() - ref.float()).abs().max().item() <= tol


# the train kernels at the shapes the meshed train path gives them: a TP
# rank's heads (12 / tp at tp = 2, 4), a pipeline micro-batch's rows and a
# data rank's packed rows (chip_smoke.py phase 20's meshes)
TRAIN_SHARD_HEADS = [6, 3]
MICRO_ROWS = [8, 16]


@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 3e-2, 0.5))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("H", TRAIN_SHARD_HEADS)
@pytest.mark.parametrize("T", [256, 512])
def test_train_kernels_at_the_tp_shard_heads(cuda, dtype, tols, rate, H, T):
    """mha_train_packed and mha_train (head-major, 64 -> 128 lanes) on a TP
    rank's heads, forward and backward, against their plain versions."""
    B, hd = 2, 64
    qkv, qb, bias, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    _compare(ta.mha_train_packed, ta.mha_train_packed_plain,
             (qkv, qb, bias, seed, H, rate, hd ** -0.5), co, tols)
    slab, slab_b = _pad_heads(qkv, H, hd), _pad_heads(qb, H, hd)
    co = torch.nn.functional.pad(co.float().reshape(B, T, H, hd), (0, 128 - hd))
    _compare(ta.mha_train, ta.mha_train_plain,
             (slab, slab_b, bias, seed, H, rate, hd ** -0.5),
             co.reshape(B, T, H * 128).to(dtype), tols)


def _compare_relative_dqb(fn, plain, args, co, tols):
    """:func:`_compare` with dqb held relative to its largest entry (a sum
    over every row of the batch)."""
    qkv, qb = args[:2]
    results = []
    for f in (fn, plain):
        a = qkv.clone().requires_grad_(True)
        b = qb.clone().requires_grad_(True)
        fwd0, bwd0 = fn.fwd_launches, fn.bwd_launches
        ctx = f(a, b, *args[2:])
        da_, db_ = torch.autograd.grad((ctx.float() * co.float()).sum(), (a, b))
        torch.cuda.synchronize()
        assert (fn.fwd_launches - fwd0, fn.bwd_launches - bwd0) == (
            (1, 1) if f is fn else (0, 0))
        results.append((ctx.float(), da_.float(), db_.float()))
    for i, (got, ref, tol) in enumerate(zip(results[0], results[1], tols)):
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        if i == 2:
            err /= max(ref.abs().max().item(), 1e-6)
        assert err <= tol


@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 4e-2, 2e-2))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B", MICRO_ROWS)
def test_mha_train_packed_at_the_micro_batch_rows(cuda, dtype, tols, rate, B):
    """All 12 heads at T = 256 on a pipeline micro-batch's (and a data
    rank's) rows."""
    H, hd, T = 12, 64, 256
    qkv, qb, bias, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    _compare_relative_dqb(ta.mha_train_packed, ta.mha_train_packed_plain,
                          (qkv, qb, bias, seed, H, rate, hd ** -0.5), co, tols)


@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, (1e-5, 1e-5, 1e-4)), (torch.bfloat16, (2e-2, 8e-2, 2e-2))])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mha_train_packed_seg_at_a_data_ranks_rows(cuda, dtype, tols, rate):
    """A data rank's 8 packed rows of 512, 12 heads, packer-style ids."""
    B, H, hd, T = 8, 12, 64, 512
    qkv, qb, _, co, seed = _train_attention_case(cuda, B, T, H, hd, dtype)
    seg = _segment_ids(cuda, B, T, "packer")
    _compare_relative_dqb(ta.mha_train_packed_seg, ta.mha_train_packed_seg_plain,
                          (qkv, qb, seg, seed, H, rate, hd ** -0.5), co, tols)
