"""The port's segment-masked train attention (plain version, which CPU
tensors take) vs the JAX package's ``mha_train_packed_seg`` Pallas kernel in
interpret mode and vs the XLA segment mask of ``gpt2_forward``; dropout at
rate 0.1 against itself (JAX's dropout bits cannot match)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops import train_attention as jta
from mmtg_tpu_torch.ops import train_attention as ta

from _torch_parity import leaf_close

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jta.INTERPRET = True
    yield
    jta.INTERPRET = False


def _segments(B, T, kind, rng):
    if kind == "packer":  # ascending ids, then the pad slots' own segment
        seg = np.full((B, T), 2 ** 15, np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(8, T - 20), 3, replace=False))
            for s, (lo, hi) in enumerate(zip(np.r_[0, cuts[:-1]], cuts)):
                seg[b, lo:hi] = s
        return seg
    return rng.integers(0, 3, (B, T)).astype(np.int32)  # arbitrary, unsorted


def _case(B, H, T, hd, kind, seed=0):
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((B, T, 3 * H * hd)) * 0.7).astype(np.float32)
    qb = (rng.standard_normal(3 * H * hd) * 0.1).astype(np.float32)
    co = rng.standard_normal((B, T, H * hd)).astype(np.float32)
    return qkv, qb, _segments(B, T, kind, rng), co




@pytest.mark.parametrize("kind", ["packer", "random"])
@pytest.mark.parametrize("B,H,T,hd", [(2, 2, 128, 64), (1, 3, 256, 64)])
def test_seg_plain_matches_jax_kernel_forward_and_grad(interpret_mode, B, H, T, hd, kind):
    qkv, qb, seg, co = _case(B, H, T, hd, kind)
    scale = float(1.0 / np.sqrt(hd))
    jseed = jnp.zeros((1,), jnp.int32)

    def jloss(x, b):
        out = jta.mha_train_packed_seg(x, b, jnp.asarray(seg), jseed, H, 0.0, scale)
        return jnp.sum(out * jnp.asarray(co)), out

    (_, ref), (ref_dqkv, ref_dqb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                       has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(qb))
    x = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(qb).requires_grad_(True)
    launches = (ta.mha_train_packed_seg.fwd_launches,
                ta.mha_train_packed_seg.bwd_launches)
    out = ta.mha_train_packed_seg(x, b, torch.from_numpy(seg),
                                  torch.zeros(1, dtype=torch.int32), H, 0.0, scale)
    dqkv, dqb = torch.autograd.grad((out * torch.from_numpy(co)).sum(), (x, b))
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launches == (ta.mha_train_packed_seg.fwd_launches,
                        ta.mha_train_packed_seg.bwd_launches)
    assert float(np.abs(out.detach().numpy() - np.asarray(ref)).max()) <= 1e-5
    leaf_close(dqkv.numpy(), ref_dqkv, 1e-5)
    leaf_close(dqb.numpy(), ref_dqb, 1e-5)


def test_seg_plain_matches_the_xla_segment_mask():
    """The mask ``gpt2_forward(attn_impl="xla", segment_ids=...)`` builds:
    ``causal & (seg_i == seg_j)`` as a ``[B, 1, T, T]`` additive bias."""
    B, H, T, hd = 2, 2, 128, 32
    qkv, qb, seg, _ = _case(B, H, T, hd, "random", seed=3)
    scale = float(1.0 / np.sqrt(hd))
    q, k, v = jnp.split(jnp.asarray(qkv + qb), 3, axis=-1)
    q, k, v = (t.reshape(B, T, H, hd).transpose(0, 2, 1, 3) for t in (q, k, v))
    s = jnp.asarray(seg)
    eq = s[:, None, :, None] == s[:, None, None, :]
    bias = jnp.where(jnp.tril(jnp.ones((T, T), bool))[None, None] & eq, 0.0, jta.NEG_INF)
    probs = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias, axis=-1)
    ref = jnp.einsum("bhqk,bhkd->bhqd", probs, v).transpose(0, 2, 1, 3).reshape(B, T, H * hd)
    out = ta.mha_train_packed_seg_plain(
        torch.from_numpy(qkv), torch.from_numpy(qb), torch.from_numpy(seg),
        torch.zeros(1, dtype=torch.int32), H, 0.0, scale)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-5


def test_seg_equals_key_bias_version_on_one_segment():
    """All ids equal: the segment version is the key-bias version with no
    padding."""
    B, H, T, hd = 2, 2, 128, 64
    qkv, qb, _, _ = _case(B, H, T, hd, "random", seed=4)
    args = (torch.from_numpy(qkv), torch.from_numpy(qb))
    seed = torch.tensor([5], dtype=torch.int32)
    a = ta.mha_train_packed_seg_plain(*args, torch.full((B, T), 7, dtype=torch.int32),
                                      seed, H, 0.1, 0.125)
    b = ta.mha_train_packed_plain(*args, torch.zeros(B, T), seed, H, 0.1, 0.125)
    assert torch.equal(a, b)


def test_seg_tokens_never_see_another_segment():
    """Changing one segment's k/v leaves every other segment's context as it
    was, bit for bit; pad slots (their own id) stay finite."""
    B, H, T, hd = 1, 2, 128, 64
    qkv, qb, seg, _ = _case(B, H, T, hd, "packer", seed=5)
    seed = torch.zeros(1, dtype=torch.int32)
    run = lambda x: ta.mha_train_packed_seg_plain(  # noqa: E731
        torch.from_numpy(x), torch.from_numpy(qb), torch.from_numpy(seg), seed,
        H, 0.0, 0.125)
    base = run(qkv)
    other = qkv.copy()
    other[0, seg[0] == 1] += 1.0
    moved = run(other)
    same = torch.from_numpy(seg[0] != 1)
    assert torch.equal(base[0, same], moved[0, same])
    assert not torch.equal(base[0, ~same], moved[0, ~same])
    assert torch.isfinite(base).all()


def test_seg_dropout_same_seed_same_mask_and_backward_regenerates_it():
    B, H, T, hd, rate = 2, 2, 128, 64, 0.1
    qkv, qb, seg, co = _case(B, H, T, hd, "packer", seed=1)
    scale = float(1.0 / np.sqrt(hd))
    seed = torch.tensor([2024], dtype=torch.int32)
    keep = ta.dropout_keep_mask(seed, B, H, T, rate)
    tseg = torch.from_numpy(seg)

    def reference(x, b):
        q, k, v = (x + b).split(H * hd, dim=-1)
        q, k, v = (t.view(B, T, H, hd).transpose(1, 2) for t in (q, k, v))
        s = torch.einsum("bhid,bhjd->bhij", q, k) * scale
        ok = (tseg[:, None, :, None] == tseg[:, None, None, :]) & torch.ones(
            T, T, dtype=torch.bool).tril()
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1) * keep / (1.0 - rate)
        return torch.einsum("bhij,bhjd->bhid", p, v).transpose(1, 2).reshape(B, T, H * hd)

    outs = []
    for fn in (lambda x, b: ta.mha_train_packed_seg(x, b, tseg, seed, H, rate, scale),
               lambda x, b: ta.mha_train_packed_seg(x, b, tseg, seed, H, rate, scale),
               reference):
        x = torch.from_numpy(qkv).requires_grad_(True)
        b = torch.from_numpy(qb).requires_grad_(True)
        out = fn(x, b)
        outs.append((out.detach(),) + torch.autograd.grad(
            (out * torch.from_numpy(co)).sum(), (x, b)))
    for a, b in zip(outs[0], outs[1]):  # same seed: the same mask, bit for bit
        assert torch.equal(a, b)
    for got, ref, tol in zip(outs[0], outs[2], (1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol)
    other = ta.mha_train_packed_seg_plain(
        torch.from_numpy(qkv), torch.from_numpy(qb), tseg,
        torch.tensor([2025], dtype=torch.int32), H, rate, scale)
    assert not torch.equal(other, outs[0][0])


def test_seg_gets_no_gradient_and_check_rejects_a_float_mask():
    B, H, T, hd = 1, 2, 128, 64
    qkv, qb, seg, _ = _case(B, H, T, hd, "packer")
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = ta.mha_train_packed_seg(x, torch.from_numpy(qb), torch.from_numpy(seg),
                                  torch.zeros(1, dtype=torch.int32), H)
    assert out.shape == (B, T, H * hd) and out.requires_grad
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="seg must be"):
        ta._check(ta.mha_train_packed_seg, x.detach(), torch.from_numpy(qb),
                  torch.zeros(B, T), seed, H)
    with pytest.raises(TypeError, match="bias must be"):
        ta._check(ta.mha_train_packed, x.detach(), torch.from_numpy(qb),
                  torch.from_numpy(seg), seed, H)
    with pytest.raises(ValueError, match="T=640"):
        ta._check(ta.mha_train_packed_seg, torch.zeros(1, 640, 3 * H * hd),
                  torch.from_numpy(qb), torch.zeros(1, 640, dtype=torch.int32), seed, H)
