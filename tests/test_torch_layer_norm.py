"""The residual LayerNorm on the CPU: ``add_layer_norm_rows`` (the decode
step's pending ``h + y + bias`` and the LayerNorm of the sum, one launch on
the card) against the eager adds and ``layer_norm_plain`` bit for bit,
against the JAX package's LayerNorm, its input checks, and the per-layer
decode step that carries each residual into the next LayerNorm against a loop
with the eager order. The kernel's side is
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 2."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.models.gpt2 import _layer_norm as jax_layer_norm
from mmtg_tpu_torch.configs import GPT2Config, ModelConfig
from mmtg_tpu_torch.models import gpt2
from mmtg_tpu_torch.ops.decode_attention import decode_attention_append_plain
from mmtg_tpu_torch.ops.layer_norm import (add_layer_norm_plain, add_layer_norm_rows,
                                           layer_norm_plain, layer_norm_rows)
from mmtg_tpu_torch.ops.matmul import matmul_plain
from mmtg_tpu_torch.params import init_params

torch.set_num_threads(2)
SHAPES = [((3,), 48), ((2, 5), 32), ((4,), 768), ((3,), 100)]
EPS = 1e-5


def _case(lead, D, seed=3):
    """h, y ``lead + (D,)`` and bias, g, b ``(D,)`` as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(lead + (D,)) * 2 + 0.5).astype(np.float32)
    y = rng.standard_normal(lead + (D,)).astype(np.float32)
    bias, b = ((0.1 * rng.standard_normal(D)).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    return h, y, bias, g, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,D", SHAPES)
def test_add_layer_norm_is_the_eager_adds_then_the_plain_norm(dtype, lead, D):
    """On CPU tensors the residual form is ``h + y + bias`` and
    ``layer_norm_plain`` of it, bit for bit, in either type."""
    h, y, bias, g, b = (torch.from_numpy(a).to(dtype) for a in _case(lead, D))
    h_new, out = add_layer_norm_rows(h, y, bias, g, b, EPS)
    want = h + y + bias
    assert h_new.dtype == out.dtype == dtype
    assert torch.equal(h_new, want)
    assert torch.equal(out, layer_norm_plain(want, g, b, EPS))
    again = add_layer_norm_plain(h, y, bias, g, b, EPS)
    assert torch.equal(again[0], h_new) and torch.equal(again[1], out)


@pytest.mark.parametrize("lead,D", SHAPES)
def test_add_layer_norm_matches_jax(lead, D):
    """f32: the normalised sum within 1e-5 of the JAX package's LayerNorm of
    ``h + y + b``."""
    h, y, bias, g, b = _case(lead, D, seed=5)
    want = np.asarray(jax_layer_norm(jnp.asarray(h) + jnp.asarray(y) + jnp.asarray(bias),
                                     jnp.asarray(g), jnp.asarray(b), EPS))
    _, out = add_layer_norm_rows(*(torch.from_numpy(a) for a in (h, y, bias, g, b)), EPS)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)


def _bad_inputs():
    h, y, bias, g, b = (torch.from_numpy(a) for a in _case((3,), 48))
    return {
        "y shape": ((h, y[:2], bias, g, b), ValueError),
        "bias shape": ((h, y, bias[:40], g, b), ValueError),
        "bias rows": ((h, y, y, g, b), ValueError),
        "y dtype": ((h, y.to(torch.bfloat16), bias, g, b), TypeError),
        "gain dtype": ((h, y, bias, g.double(), b), TypeError),
        "float16": (tuple(t.half() for t in (h, y, bias, g, b)), TypeError),
    }


@pytest.mark.parametrize("what", sorted(_bad_inputs()))
def test_add_layer_norm_rejects_bad_input(what):
    """A shape or type mismatch raises before the device is looked at (the
    CPU path reaches the same checks as the card's)."""
    args, err = _bad_inputs()[what]
    with pytest.raises(err):
        add_layer_norm_rows(*args, EPS)


def test_layer_norm_rows_rejects_bad_input():
    h, _, bias, g, b = (torch.from_numpy(a) for a in _case((3,), 48))
    with pytest.raises(ValueError):
        layer_norm_rows(h, g[:40], b, EPS)
    with pytest.raises(TypeError):
        layer_norm_rows(h, g.to(torch.bfloat16), b, EPS)


# the GPT-2 of tests/test_torch_batch_invariance.py::_tiny
CFG = GPT2Config(vocab_size=200, n_positions=256, n_ctx=250, n_embd=48, n_layer=2,
                 n_head=4)
B, T, STEPS = 3, 16, 3


def _eager_step(p_all, cache, x, position, tt, mask):
    """One per-layer decode step in the eager order: each residual added by
    the torch ops, then the next LayerNorm; then the final one and the LM
    head (the plain versions of every op)."""
    p, eps, D = p_all["h"], CFG.layer_norm_epsilon, CFG.n_embd
    attend = functools.partial(decode_attention_append_plain, k_cache=cache.k,
                               v_cache=cache.v, k_scale=cache.k_scale,
                               v_scale=cache.v_scale)
    h = x + p_all["wpe"][position] + p_all["wte"][tt]
    for l in range(CFG.n_layer):
        a = layer_norm_plain(h, p["ln1_g"][l], p["ln1_b"][l], eps)
        q, k, v = gpt2._mm(a, p, l, "attn_w", bias=p["attn_b"][l]).split(D, dim=-1)
        ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(), key_mask=mask,
                     position=position, layer=l, n_head=CFG.n_head)
        h = h + gpt2._mm(ctx, p, l, "attn_proj_w") + p["attn_proj_b"][l]
        m = layer_norm_plain(h, p["ln2_g"][l], p["ln2_b"][l], eps)
        m = gpt2.gelu_new(gpt2._mm(m, p, l, "mlp_fc_w", bias=p["mlp_fc_b"][l]))
        h = h + gpt2._mm(m, p, l, "mlp_proj_w") + p["mlp_proj_b"][l]
    h = layer_norm_plain(h, p_all["lnf_g"], p_all["lnf_b"], eps)
    if "wte_q" in p_all:
        return (matmul_plain(h, p_all["wte_q"].to(h.dtype).T) * p_all["wte_s"].T).to(h.dtype)
    return matmul_plain(h, p_all["wte"].T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8_weights", [False, True], ids=["model", "int8_weights"])
def test_decode_step_carries_the_residual_into_the_next_norm(dtype, int8_weights):
    """``gpt2_decode_step(use_kernels=False)``, per layer, over three steps
    with an int8 cache: logits bit-equal to the eager loop's, and the caches
    too (the LayerNorms' gains and biases and the residuals' biases drawn
    away from 1 and 0)."""
    params = init_params(ModelConfig(gpt2=CFG), seed=4, dtype=dtype)["gpt2"]
    rng = np.random.default_rng(11)
    for key in ("ln1_g", "ln2_g", "lnf_g", "ln1_b", "ln2_b", "lnf_b", "attn_proj_b",
                "mlp_proj_b"):
        tree = params if key.startswith("lnf") else params["h"]
        noise = torch.from_numpy(0.2 * rng.standard_normal(tree[key].shape).astype(np.float32))
        tree[key] = (tree[key].float() + noise).to(dtype)
    if int8_weights:
        params = gpt2.quantize_decode_weights(params)
    caches = [gpt2.init_cache(CFG, B, T, dtype, "int8") for _ in range(2)]
    for position in range(STEPS):
        x = torch.from_numpy(rng.standard_normal((B, CFG.n_embd)).astype(np.float32)).to(dtype)
        tt = torch.from_numpy(rng.integers(0, 2, B))
        mask = torch.from_numpy(
            np.tile((np.arange(T) <= position).astype(np.int32), (B, 1)))
        got = gpt2.gpt2_decode_step(params, CFG, caches[0], x, position, tt, mask,
                                    use_kernels=False)
        want = _eager_step(params, caches[1], x, position, tt, mask)
        assert got.dtype == dtype
        assert torch.equal(got, want), position
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(caches[0], name), getattr(caches[1], name)), name
