"""Port's fused GRU (plain PyTorch version, as run for CPU tensors) and GRU
scan vs the JAX Pallas kernel in interpret mode and the JAX scan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops.fused_gru import fused_gru as jax_fused_gru
from mmtg_tpu.ops.rnn import init_rnn_params, rnn_forward as jax_rnn_forward
from mmtg_tpu_torch.ops.fused_gru import fused_gru, fused_gru_plain
from mmtg_tpu_torch.ops.rnn import rnn_forward
from mmtg_tpu_torch.params import from_jax_numpy

torch.set_num_threads(2)

T, I, H = 5, 64, 32


def _setup(B, seed=0, num_layers=1):
    p = init_rnn_params(jax.random.PRNGKey(seed), "GRU", I, H, num_layers)
    x = np.random.default_rng(seed).standard_normal((T, B, I)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("B", [4, 8, 30])
def test_fused_gru_matches_jax(B):
    p, x = _setup(B)
    lp = p["layers"][0]
    ref_kernel = jax_fused_gru(jnp.asarray(x), lp["w_ih"], lp["w_hh"],
                               lp["b_ih"], lp["b_hh"], block_b=4,
                               interpret=True)
    ref_scan, _ = jax_rnn_forward(p, jnp.asarray(x), "GRU")
    tp = from_jax_numpy(lp)
    out = fused_gru(torch.from_numpy(x), tp["w_ih"], tp["w_hh"], tp["b_ih"],
                    tp["b_hh"])
    assert out.shape == (T, B, H) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_scan), atol=1e-5)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_gru_scan_matches_jax(num_layers):
    p, x = _setup(6, seed=1, num_layers=num_layers)
    ref_out, ref_h = jax_rnn_forward(p, jnp.asarray(x), "GRU")
    out, h = rnn_forward(from_jax_numpy(p), torch.from_numpy(x), "GRU")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-5)


def test_fused_gru_bf16_keeps_f32_state():
    """bf16 inputs: the recurrence runs in f32 (as the kernel does) and only
    the output is rounded, so it tracks the f32 run to bf16 precision."""
    p, x = _setup(8, seed=2)
    tp = from_jax_numpy(p["layers"][0])
    args = [tp[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    ref = fused_gru_plain(torch.from_numpy(x), *args)
    out = fused_gru_plain(torch.from_numpy(x).bfloat16(),
                          *[a.bfloat16() for a in args])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


def test_other_cells_are_not_ported():
    """The LSTM and RNN(relu) cells are ported since (test_torch_rnn.py holds
    them to JAX in full): here they run beside the GRU on the same inputs
    and equal the JAX scan; a kind that names no cell raises."""
    _, x = _setup(2)
    for kind in ("LSTM", "RNN"):
        p = init_rnn_params(jax.random.PRNGKey(1), kind, I, H, 1)
        ref, _ = jax_rnn_forward(p, jnp.asarray(x), kind)
        out, _ = rnn_forward(from_jax_numpy(p), torch.from_numpy(x), kind)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="unknown rnn kind"):
        rnn_forward(from_jax_numpy(_setup(2)[0]), torch.from_numpy(x), "TRM")
