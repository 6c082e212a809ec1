"""The port's head-major train attention (``mha_train``; plain version for CPU
tensors) vs the JAX package's ``mha_train`` Pallas kernel in interpret mode,
the weight-side padding helpers vs JAX's exactly, and ``gpt2_forward``'s
``attn_impl="kernel_padded"`` vs the standard-slab path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops import train_attention as jta
from mmtg_tpu_torch.models import gpt2
from mmtg_tpu_torch.ops import train_attention as ta
from mmtg_tpu_torch.params import init_gpt2_params, tree_leaves, tree_map

from _torch_parity import leaf_close, to_port_config, train_configs

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jta.INTERPRET = True
    yield
    jta.INTERPRET = False


def _weights(D, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((D, 3 * H * hd)) * 0.05).astype(np.float32),
            (rng.standard_normal(3 * H * hd) * 0.1).astype(np.float32),
            (rng.standard_normal((H * hd, D)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("H,hd", [(2, 64), (3, 32), (1, 128), (2, 40)])
def test_pad_weights_equal_jax_exactly(H, hd):
    D = 48
    w, b, pw = _weights(D, H, hd)
    jw, jb = jta.pad_qkv_weights(jnp.asarray(w), jnp.asarray(b), H, hd)
    tw, tb = ta.pad_qkv_weights(torch.from_numpy(w), torch.from_numpy(b), H, hd)
    assert tw.shape == (D, H * 384) and tb.shape == (H * 384,)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        ta.pad_proj_weights(torch.from_numpy(pw), H, hd).numpy(),
        np.asarray(jta.pad_proj_weights(jnp.asarray(pw), H, hd)))


def test_pad_weights_reject_a_head_wider_than_128():
    with pytest.raises(ValueError, match="head_dim 136"):
        ta.pad_qkv_weights(torch.zeros(8, 3 * 136), torch.zeros(3 * 136), 1, 136)
    with pytest.raises(ValueError, match="head_dim 136"):
        ta.pad_proj_weights(torch.zeros(136, 8), 1, 136)


def _case(B, H, T, hd, seed=0):
    """A head-major slab as the padded projection emits it (zero pad lanes)."""
    rng = np.random.default_rng(seed)
    D = 32
    w, b, _ = _weights(D, H, hd, seed)
    a = rng.standard_normal((B, T, D)).astype(np.float32) * 3.0
    wq, bq = ta.pad_qkv_weights(torch.from_numpy(w), torch.from_numpy(b), H, hd)
    qkv = (torch.from_numpy(a) @ wq).numpy()
    mask = np.ones((B, T), np.float32)
    mask[:, T - 9:] = 0.0
    mask[0, 3:5] = 0.0
    bias = ((1.0 - mask) * ta.NEG_INF).astype(np.float32)
    co = rng.standard_normal((B, T, H * 128)).astype(np.float32)
    co.reshape(B, T, H, 128)[..., hd:] = 0.0  # d(ctx) pad lanes, as the padded proj gives
    return qkv, bq.numpy(), bias, co




@pytest.mark.parametrize("B,H,T,hd", [(2, 2, 128, 64), (1, 3, 256, 32)])
def test_mha_train_plain_matches_jax_kernel_forward_and_grad(interpret_mode, B, H, T, hd):
    qkv, qb, bias, co = _case(B, H, T, hd)
    scale = float(1.0 / np.sqrt(hd))
    jseed = jnp.zeros((1,), jnp.int32)

    def jloss(x, b):
        out = jta.mha_train(x, b, jnp.asarray(bias), jseed, H, 0.0, scale)
        return jnp.sum(out * jnp.asarray(co)), out

    (_, ref), (ref_dqkv, ref_dqb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                       has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(qb))
    x = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(qb).requires_grad_(True)
    out = ta.mha_train(x, b, torch.from_numpy(bias),
                       torch.zeros(1, dtype=torch.int32), H, 0.0, scale)
    assert ta.mha_train.fwd_launches == 0  # a CPU tensor takes the plain version
    dqkv, dqb = torch.autograd.grad((out * torch.from_numpy(co)).sum(), (x, b))
    assert out.shape == (B, T, H * 128)
    assert float(np.abs(out.detach().numpy() - np.asarray(ref)).max()) <= 1e-5
    leaf_close(dqkv.numpy(), ref_dqkv, 1e-5)
    leaf_close(dqb.numpy(), ref_dqb, 1e-5)
    # pad lanes: zero context, zero gradient
    assert float(out.detach().view(B, T, H, 128)[..., hd:].abs().max()) == 0.0
    assert float(dqkv.view(B, T, H, 3, 128)[..., hd:].abs().max()) == 0.0


def test_mha_train_plain_equals_the_packed_plain_on_the_same_heads():
    B, H, T, hd = 2, 2, 128, 64
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy((rng.standard_normal((B, T, 3 * H * hd)) * 0.7).astype(np.float32))
    qb = torch.from_numpy((rng.standard_normal(3 * H * hd) * 0.1).astype(np.float32))
    bias = torch.zeros(B, T)
    bias[:, 100:] = ta.NEG_INF
    seed = torch.tensor([11], dtype=torch.int32)
    ref = ta.mha_train_packed_plain(qkv, qb, bias, seed, H, 0.1, 0.125)
    # the same q, k, v in the head-major padded layout
    pad = lambda t: torch.nn.functional.pad(  # noqa: E731
        t.reshape(t.shape[:-1] + (3, H, hd)), (0, 128 - hd)).transpose(-3, -2).reshape(
            t.shape[:-1] + (H * 384,))
    out = ta.mha_train_plain(pad(qkv), pad(qb), bias, seed, H, 0.1, 0.125)
    np.testing.assert_allclose(out.view(B, T, H, 128)[..., :hd].reshape(B, T, H * hd).numpy(),
                               ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
def test_gpt2_forward_head_major_equals_the_packed_path(dropout):
    """Logits and every parameter gradient; with dropout on too, since both
    slabs index the mask by (batch row, head, i, j)."""
    mcfg, _ = train_configs()
    cfg = to_port_config(mcfg).gpt2
    rng = np.random.default_rng(6)
    params = init_gpt2_params(cfg, seed=4)
    B, T = 2, 100
    x = torch.from_numpy((rng.standard_normal((B, T, cfg.n_embd)) * 0.1).astype(np.float32))
    mask = torch.ones(B, T, dtype=torch.int32)
    mask[0, 80:] = 0
    co = torch.from_numpy(rng.standard_normal((B, T, cfg.vocab_size)).astype(np.float32))
    got = {}
    for impl in ("kernel", "kernel_padded"):
        p = tree_map(lambda t: t.clone().requires_grad_(True), params)
        p["h"]["attn_b"].data.add_(0.05)
        gen = torch.Generator().manual_seed(3) if dropout else None
        logits, _ = gpt2.gpt2_forward(p, cfg, x, torch.arange(T)[None], None, mask,
                                      dropout_gen=gen, deterministic=not dropout,
                                      remat=dropout, attn_impl=impl)
        grads = torch.autograd.grad((logits * co).sum(), tree_leaves(p))
        got[impl] = (logits.detach(), grads)
    assert float((got["kernel"][0] - got["kernel_padded"][0]).abs().max()) <= 1e-5
    for a, b in zip(got["kernel"][1], got["kernel_padded"][1]):
        leaf_close(b.numpy(), a.numpy(), 1e-5)


def test_gpt2_forward_head_major_with_segments_takes_the_seg_function(monkeypatch):
    """Only the standard slab takes segment ids (as in the JAX package)."""
    mcfg, _ = train_configs()
    cfg = to_port_config(mcfg).gpt2
    params = init_gpt2_params(cfg, seed=4)
    calls = []

    def spy(qkv, qkv_bias, seg, seed, n_head, rate, scale):
        calls.append((tuple(qkv.shape), seg.dtype, int(seg.max())))
        return ta.mha_train_packed_seg_plain(qkv, qkv_bias, seg, seed, n_head, rate, scale)

    monkeypatch.setattr(gpt2, "mha_train_packed_seg", spy)
    x = torch.zeros(1, 100, cfg.n_embd)
    seg = torch.zeros(1, 100, dtype=torch.int32)
    gpt2.gpt2_forward(params, cfg, x, torch.arange(100)[None], segment_ids=seg,
                      attn_impl="kernel_padded")
    # the standard slab, padded to 128 rows whose pad slots carry segment 2**15
    assert calls == [((1, 128, 3 * cfg.n_embd), torch.int32, 2 ** 15)] * cfg.n_layer
    with pytest.raises(ValueError, match="train-path only"):
        gpt2.gpt2_forward(params, cfg, x, torch.arange(100)[None], segment_ids=seg,
                          return_kv=True)
    with pytest.raises(ValueError, match="attn_impl"):
        gpt2.gpt2_forward(params, cfg, x, torch.arange(100)[None], attn_impl="pallas")
