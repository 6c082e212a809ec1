"""The whole-step decode kernel's plain version (decode_block_fused_plain, what
the port runs on the CPU) vs the JAX package's decode_block_fused in interpret
mode, at the sizes of tests/test_decode_megakernel.py: hidden state and logits
<= 5e-3, appended codes within 1, scales rtol 1e-4 (the two sum their products
in another order, so a k/v entry differs in its last bits and a code on a
rounding boundary lands one apart), the slot after ``position`` untouched; a
6-step rollout; and, inside the port, the per-layer decode step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.configs import GPT2Config
from mmtg_tpu.models import gpt2 as jgpt2
from mmtg_tpu.ops import decode_megakernel as jmk
from mmtg_tpu_torch.models import gpt2
from mmtg_tpu_torch.ops import decode_megakernel as mk
from mmtg_tpu_torch.params import from_jax_numpy, kv_cache_from_jax_numpy

from _torch_parity import to_port_config

torch.set_num_threads(2)
CFG = GPT2Config(vocab_size=120, n_positions=300, n_ctx=300, n_embd=128,
                 n_layer=3, n_head=4)
B, T = 8, 256
L, D = CFG.n_layer, CFG.n_embd


@pytest.fixture(scope="module")
def params():
    jp = jgpt2.init_gpt2_params(jax.random.PRNGKey(0), CFG)
    # biases and gains off their init values, so that each one matters
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree.flatten(jp)
    leaves = [x + 0.02 * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves]
    jp = jax.tree.unflatten(treedef, leaves)
    return jp, from_jax_numpy(jp)


def _inputs(seed, position):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, T, D)).astype(np.float32)
    v = rng.standard_normal((L, B, T, D)).astype(np.float32)
    (kq, ks), (vq, vs) = (jgpt2.quantize_rows(jnp.asarray(a)) for a in (k, v))
    cache = [np.asarray(a) for a in (kq, vq, ks, vs)]  # garbage beyond position
    x = (rng.standard_normal((B, D)) * 0.1).astype(np.float32)
    tt = rng.integers(0, 5, (B,)).astype(np.int32)
    mask = np.tile((np.arange(T)[None, :] <= position).astype(np.int32), (B, 1))
    if position >= 2:
        mask[1, position // 2] = 0  # a hole inside one row's prefix
    return cache, x, tt, mask


def _jax_step(jp, cache, x, tt, mask, position):
    h = (jnp.asarray(x) + jp["wpe"][position] + jnp.take(jp["wte"], jnp.asarray(tt), axis=0))
    h_out, k, v, ks, vs = jmk.decode_block_fused(
        h, jp["h"], *(jnp.array(c) for c in cache), jnp.asarray(mask),
        jnp.asarray(position), n_head=CFG.n_head, eps=CFG.layer_norm_epsilon,
        block_b=4, tile_t=64, interpret=True)
    logits = jgpt2._layer_norm(h_out, jp["lnf_g"], jp["lnf_b"],
                               CFG.layer_norm_epsilon) @ jp["wte"].T
    return np.asarray(h_out), np.asarray(logits), [np.asarray(a) for a in (k, v, ks, vs)]


def _torch_step(tp, cache, x, tt, mask, position, attn_impl="fused"):
    tcache = kv_cache_from_jax_numpy(*cache)
    logits = gpt2.gpt2_decode_step(
        tp, to_port_config(CFG), tcache, torch.from_numpy(x), position,
        torch.from_numpy(tt).long(), torch.from_numpy(mask), attn_impl=attn_impl)
    return logits.numpy(), [t.numpy() for t in tcache[:4]]


@pytest.mark.parametrize("position", [0, 5, 63, 64, 130, 255])
def test_plain_matches_jax_megakernel(params, position):
    jp, tp = params
    cache, x, tt, mask = _inputs(position + 1, position)
    ref_h, ref_logits, ref_cache = _jax_step(jp, cache, x, tt, mask, position)
    h = (torch.from_numpy(x) + tp["wpe"][position] + tp["wte"][torch.from_numpy(tt).long()])
    tc = [torch.from_numpy(c.copy()) for c in cache]
    got_h = mk.decode_block_fused(h, tp["h"], *tc, torch.from_numpy(mask), position,
                                  n_head=CFG.n_head, eps=CFG.layer_norm_epsilon)
    np.testing.assert_allclose(got_h.numpy(), ref_h, atol=5e-3, rtol=0)
    got_logits, got_cache = _torch_step(tp, cache, x, tt, mask, position)
    np.testing.assert_allclose(got_logits, ref_logits, atol=5e-3, rtol=0)
    for got, ref, c in zip(got_cache, ref_cache, tc):
        np.testing.assert_array_equal(got, c.numpy())  # wrapper == step
    for i in (0, 1):
        diff = np.abs(got_cache[i].astype(np.int32) - ref_cache[i].astype(np.int32))
        assert diff.max() <= 1
        diff[:, :, position] = 0
        assert diff.max() == 0  # only slot `position` was written
        np.testing.assert_allclose(got_cache[2 + i][:, :, position],
                                   ref_cache[2 + i][:, :, position], rtol=1e-4)
        if position + 1 < T:
            np.testing.assert_array_equal(got_cache[i][:, :, position + 1],
                                          cache[i][:, :, position + 1])


def test_six_step_rollout_matches_jax(params):
    """Each path feeds its own updated cache forward from a shared prefix."""
    jp, tp = params
    start = 62
    jcache, _, _, _ = _inputs(7, start)
    tcache = [c.copy() for c in jcache]
    rng = np.random.default_rng(8)
    for i in range(6):
        position = start + i
        x = (rng.standard_normal((B, D)) * 0.1).astype(np.float32)
        tt = rng.integers(0, 5, (B,)).astype(np.int32)
        mask = np.tile((np.arange(T)[None, :] <= position).astype(np.int32), (B, 1))
        _, ref_logits, jcache = _jax_step(jp, jcache, x, tt, mask, position)
        got_logits, tcache = _torch_step(tp, tcache, x, tt, mask, position)
        np.testing.assert_allclose(got_logits, ref_logits, atol=5e-3, rtol=0,
                                   err_msg=f"step {i} (position {position})")


@pytest.mark.parametrize("position", [0, 64, 255])
def test_fused_step_equals_per_layer_step_in_the_port(params, position):
    """On the CPU both run the same plain functions in the same order: equal
    logits and caches bit for bit."""
    _, tp = params
    cache, x, tt, mask = _inputs(40 + position, position)
    a_logits, a_cache = _torch_step(tp, cache, x, tt, mask, position, "fused")
    b_logits, b_cache = _torch_step(tp, cache, x, tt, mask, position, "kernel")
    np.testing.assert_array_equal(a_logits, b_logits)
    for a, b in zip(a_cache, b_cache):
        np.testing.assert_array_equal(a, b)


def test_fused_scope_raises_outside_it(params):
    _, tp = params
    cfg = to_port_config(CFG)
    x = torch.zeros(B, D)
    tt = torch.zeros(B, dtype=torch.long)
    mask = torch.ones(B, T, dtype=torch.int32)
    for cache_dtype in ("model", "int4"):
        cache = gpt2.init_cache(cfg, B, T, torch.float32, cache_dtype)
        with pytest.raises(ValueError):
            gpt2.gpt2_decode_step(tp, cfg, cache, x, 3, tt, mask, attn_impl="fused")
    int8 = gpt2.init_cache(cfg, B, T, torch.float32, "int8")
    with pytest.raises(ValueError):  # the merged buffer
        gpt2.gpt2_decode_step(tp, cfg, gpt2.merge_kv(int8), x, 3, tt, mask,
                              attn_impl="fused")
    with pytest.raises(ValueError):  # weight-only int8
        gpt2.gpt2_decode_step(gpt2.quantize_decode_weights(tp), cfg, int8, x, 3, tt,
                              mask, attn_impl="fused")
    with pytest.raises(ValueError):
        gpt2.gpt2_decode_step(tp, cfg, int8, x, 3, tt, mask, attn_impl="pallas")
