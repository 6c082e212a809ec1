"""The port's train attention (plain version, which CPU tensors take) vs the
JAX package's ``mha_train_packed`` Pallas kernel in interpret mode, and the
port's dropout hash and dropout math against an independent reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops import train_attention as jta
from mmtg_tpu_torch.ops import train_attention as ta

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jta.INTERPRET = True
    yield
    jta.INTERPRET = False


def _case(B, H, T, hd, seed=0):
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((B, T, 3 * H * hd)) * 0.7).astype(np.float32)
    qb = (rng.standard_normal(3 * H * hd) * 0.1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[:, T - 9:] = 0.0  # a key-padding tail
    mask[0, 3:5] = 0.0
    bias = ((1.0 - mask) * ta.NEG_INF).astype(np.float32)
    co = rng.standard_normal((B, T, H * hd)).astype(np.float32)
    return qkv, qb, bias, co


@pytest.mark.parametrize("B,H,T,hd", [(2, 2, 128, 64), (1, 3, 256, 64)])
def test_plain_matches_jax_kernel_forward_and_grad(interpret_mode, B, H, T, hd):
    qkv, qb, bias, co = _case(B, H, T, hd)
    scale = float(1.0 / np.sqrt(hd))
    jseed = jnp.zeros((1,), jnp.int32)

    def jloss(x, b):
        out = jta.mha_train_packed(x, b, jnp.asarray(bias), jseed, H, 0.0, scale)
        return jnp.sum(out * jnp.asarray(co)), out

    (_, ref), (ref_dqkv, ref_dqb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                       has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(qb))

    x = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(qb).requires_grad_(True)
    launches = (ta.mha_train_packed.fwd_launches, ta.mha_train_packed.bwd_launches)
    out = ta.mha_train_packed(x, b, torch.from_numpy(bias),
                              torch.zeros(1, dtype=torch.int32), H, 0.0, scale)
    dqkv, dqb = torch.autograd.grad((out * torch.from_numpy(co)).sum(), (x, b))
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launches == (ta.mha_train_packed.fwd_launches,
                        ta.mha_train_packed.bwd_launches)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-6)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(ref_dqkv), atol=2e-6)
    # the bias gradient sums B*T rows: summation order differs
    np.testing.assert_allclose(dqb.numpy(), np.asarray(ref_dqb), atol=1e-4)


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_dropout_keep_mask_is_the_documented_hash():
    B, H, T, rate, seed = 2, 3, 128, 0.1, 987654321
    mask = ta.dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), B, H, T, rate)
    assert mask.shape == (B, H, T, T) and mask.dtype == torch.bool
    thr = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    skey = _fmix32((seed + 0x9E3779B9) & 0xFFFFFFFF)
    for b, h, i, j in [(0, 0, 0, 0), (1, 2, 127, 127), (0, 1, 5, 99), (1, 0, 64, 3)]:
        row = (b * H + h) * T + i
        bits = _fmix32((_fmix32(row ^ skey) + j * 0x9E3779B9) & 0xFFFFFFFF)
        assert bool(mask[b, h, i, j]) == (bits >= thr)


def test_dropout_keep_mask_deterministic_and_grid_independent():
    seed = torch.tensor([42], dtype=torch.int32)
    a = ta.dropout_keep_mask(seed, 2, 3, 128, 0.1)
    assert torch.equal(a, ta.dropout_keep_mask(seed, 2, 3, 128, 0.1))
    # an element's bit depends on (seed, row, j) only: the first batch row of
    # a larger batch is the same mask
    big = ta.dropout_keep_mask(seed, 4, 3, 128, 0.1)
    assert torch.equal(a, big[:2])
    other = ta.dropout_keep_mask(torch.tensor([43], dtype=torch.int32), 2, 3, 128, 0.1)
    assert not torch.equal(a, other)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_fraction(rate):
    mask = ta.dropout_keep_mask(torch.tensor([7], dtype=torch.int32), 4, 4, 128, rate)
    n = mask.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(mask.float().mean().item() - (1 - rate)) < 3 * sigma
    # and per query row position, no structure along i or j
    assert abs(mask.float().mean(dim=(0, 1, 2)) - (1 - rate)).max() < 6 * np.sqrt(
        rate * (1 - rate) / (n / 128))


def test_plain_with_dropout_matches_explicit_reference():
    B, H, T, hd, rate = 2, 2, 128, 64, 0.1
    qkv, qb, bias, co = _case(B, H, T, hd, seed=1)
    scale = float(1.0 / np.sqrt(hd))
    seed = torch.tensor([2024], dtype=torch.int32)
    keep = ta.dropout_keep_mask(seed, B, H, T, rate)

    def reference(x, b):
        q, k, v = (x + b).split(H * hd, dim=-1)
        q, k, v = (t.view(B, T, H, hd).transpose(1, 2) for t in (q, k, v))
        s = torch.einsum("bhid,bhjd->bhij", q, k) * scale
        s = s + torch.from_numpy(bias)[:, None, None, :]
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))
        p = torch.softmax(s, dim=-1) * keep / (1.0 - rate)
        return torch.einsum("bhij,bhjd->bhid", p, v).transpose(1, 2).reshape(B, T, H * hd)

    outs = []
    for fn in (lambda x, b: ta.mha_train_packed(x, b, torch.from_numpy(bias), seed,
                                                H, rate, scale), reference):
        x = torch.from_numpy(qkv).requires_grad_(True)
        b = torch.from_numpy(qb).requires_grad_(True)
        out = fn(x, b)
        outs.append((out.detach(),) + torch.autograd.grad(
            (out * torch.from_numpy(co)).sum(), (x, b)))
    for got, ref, tol in zip(outs[0], outs[1], (1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol)
    # dropout did something: rate 0 gives another context
    plain0 = ta.mha_train_packed_plain(torch.from_numpy(qkv), torch.from_numpy(qb),
                                       torch.from_numpy(bias), seed, H, 0.0, scale)
    assert (plain0 - outs[0][0]).abs().max() > 1e-3


def test_bf16_plain_keeps_slab_dtype_and_f32_softmax():
    B, H, T, hd = 1, 2, 128, 64
    qkv, qb, bias, _ = _case(B, H, T, hd)
    out = ta.mha_train_packed_plain(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(qb).bfloat16(),
        torch.from_numpy(bias), torch.zeros(1, dtype=torch.int32), H, 0.0, 0.125)
    ref = ta.mha_train_packed_plain(
        torch.from_numpy(qkv), torch.from_numpy(qb), torch.from_numpy(bias),
        torch.zeros(1, dtype=torch.int32), H, 0.0, 0.125)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max() < 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,ok", [(640, True), (1024, True), (1100, False),
                                  (1152, False)])
@pytest.mark.parametrize("fn", ["mha_train_packed", "mha_train_packed_seg",
                                "mha_train"])
def test_kernel_row_limit_is_n_positions(fn, dtype, T, ok):
    """The wrappers take rows up to GPT-2's 1024 positions, a multiple of 128,
    in both dtypes (the JAX trainer's limit), and refuse longer or ragged ones
    before any launch."""
    f = getattr(ta, fn)
    width = ta.SLAB if f.head_major else 3 * 8
    qkv = torch.zeros(1, T, width, dtype=dtype)
    mask = torch.zeros(1, T, dtype=torch.int32 if f.seg else torch.float32)
    seed = torch.zeros(1, dtype=torch.int32)
    if ok:
        assert ta._check(f, qkv, torch.zeros(width, dtype=dtype), mask, seed, 1)[:2] == (1, T)
    else:
        with pytest.raises(ValueError, match="at most 1024"):
            ta._check(f, qkv, torch.zeros(width, dtype=dtype), mask, seed, 1)
