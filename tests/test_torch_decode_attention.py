"""Port's decode-attention append (plain PyTorch version, as run for CPU
tensors) vs the JAX Pallas kernels in interpret mode, at the shapes of
tests/test_decode_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops.decode_attention import (
    decode_attention_fp_append as jax_fp_append,
    decode_attention_int8_append as jax_int8_append,
)
from mmtg_tpu_torch.ops.decode_attention import (
    decode_attention_append_plain,
    decode_attention_fp_append,
    decode_attention_int8_append,
    quantize_rows,
)

torch.set_num_threads(2)

L, B, T, NH, HD = 3, 8, 256, 4, 32
D = NH * HD
LAYER = 1
KERNEL_ARGS = dict(n_head=NH, block_b=4, tile_t=64, interpret=True)


def _inputs(seed, int8):
    rng = np.random.default_rng(seed)
    q, k_new, v_new = (rng.standard_normal((B, D)).astype(np.float32)
                       for _ in range(3))
    mask = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask[:, 0] = 1
    if int8:
        kc = rng.integers(-127, 128, (L, B, T, D)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, B, T, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (L, B, T)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (L, B, T)).astype(np.float32)
        return q, k_new, v_new, mask, [kc, vc, ks, vs]
    kc = rng.standard_normal((L, B, T, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, T, D)).astype(np.float32)
    return q, k_new, v_new, mask, [kc, vc]


def _run_jax(int8, q, k_new, v_new, mask, caches, position):
    args = [jnp.asarray(x) for x in (q, k_new, v_new)]
    args += [jnp.asarray(c) for c in caches]
    fn = jax_int8_append if int8 else jax_fp_append
    out = fn(*args, jnp.asarray(mask), jnp.asarray(position, jnp.int32),
             jnp.asarray(LAYER, jnp.int32), **KERNEL_ARGS)
    return [np.asarray(o) for o in out]  # ctx, caches...


def _run_port(int8, q, k_new, v_new, mask, caches, position):
    t = [torch.from_numpy(x.copy()) for x in (q, k_new, v_new)]
    tc = [torch.from_numpy(c.copy()) for c in caches]
    tm = torch.from_numpy(mask)
    if int8:
        ctx = decode_attention_int8_append(*t, *tc, tm, position, LAYER,
                                           n_head=NH)
    else:
        ctx = decode_attention_fp_append(*t, *tc, tm, position, LAYER,
                                         n_head=NH)
    return [ctx.numpy()] + [c.numpy() for c in tc]


@pytest.mark.parametrize("position", [0, 5, 63, 64, 200, 255])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_append_matches_jax_kernel(position, int8):
    inputs = _inputs(position + 7 * int8, int8)
    ref = _run_jax(int8, *inputs, position)
    got = _run_port(int8, *inputs, position)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5, rtol=0)
    if not int8:
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g, r)
        return
    kc, vc, ks, vs = got[1:]
    rkc, rvc, rks, rvs = ref[1:]
    for g, r in ((kc, rkc), (vc, rvc)):
        diff = np.abs(g.astype(np.int32) - r.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(ks, rks, rtol=1e-6, atol=0)
    np.testing.assert_allclose(vs, rvs, rtol=1e-6, atol=0)
    # only slot `position` of layer LAYER was written
    _, _, _, _, before = inputs
    untouched = np.ones((L, B, T), bool)
    untouched[LAYER, :, position] = False
    np.testing.assert_array_equal(kc[untouched], before[0][untouched])
    np.testing.assert_array_equal(ks[untouched], before[2][untouched])


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_ignores_garbage_beyond_position(int8):
    """Slots past `position` never change ctx, even holding huge values."""
    q, k_new, v_new, mask, caches = _inputs(3, int8)
    pos = 30
    clean = _run_port(int8, q, k_new, v_new, mask, caches, pos)[0]
    dirty_caches = [c.copy() for c in caches]
    big = 127 if int8 else 1e4
    dirty_caches[0][:, :, pos + 1:] = big
    dirty_caches[1][:, :, pos + 1:] = -big
    if int8:
        dirty_caches[2][:, :, pos + 1:] = 1e4
        dirty_caches[3][:, :, pos + 1:] = 1e4
    dirty = _run_port(int8, q, k_new, v_new, mask, dirty_caches, pos)[0]
    np.testing.assert_array_equal(clean, dirty)


def test_quantize_rows_matches_jax():
    from mmtg_tpu.models.gpt2 import quantize_rows as jax_quantize_rows

    x = np.random.default_rng(5).standard_normal((4, 6, D)).astype(np.float32)
    x[0, 0] = 0.0  # the 1e-6 scale floor
    q, s = quantize_rows(torch.from_numpy(x))
    rq, rs = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_bf16_plain_prescales_q_in_bf16():
    """The plain version rounds q * 1/sqrt(hd) back to bf16 before the
    score dot, as the TPU wrapper does; with an f32 cache of the same
    values the two dtypes then agree to bf16 precision."""
    q, k_new, v_new, mask, caches = _inputs(11, False)
    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k_new, v_new)]
    tc = [torch.from_numpy(c).to(torch.bfloat16) for c in caches]
    ctx = decode_attention_append_plain(*tq, *tc, torch.from_numpy(mask),
                                        90, LAYER, NH)
    assert ctx.dtype == torch.bfloat16
    f32 = [t.float() for t in tq]
    ref = decode_attention_append_plain(*f32, *[c.float() for c in tc],
                                        torch.from_numpy(mask), 90, LAYER, NH)
    np.testing.assert_allclose(ctx.float().numpy(), ref.numpy(), atol=2e-2)
