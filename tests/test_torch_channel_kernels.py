"""Every encoder channel kind through the batch-invariant kernels' path, f32
on the CPU (where each kernel's wrapper runs its plain version): the LSTM,
RNN(relu), 2-layer GRU and TRM channels of ``encoder_forward`` with
``use_kernels=True`` against ``use_kernels=False`` (<= 1e-6) and both
against the JAX package's ``encoder_forward`` (<= 1e-5), on the conftest
tiny config with both experience channels of the kind; the recurrent stack's
products go through the ``mm`` it is given, and its train path stays
differentiable."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.models import encoder as jencoder
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch.models import encoder
from mmtg_tpu_torch.ops import fused_gru, rnn
from mmtg_tpu_torch.ops.matmul import matmul, matmul_plain
from mmtg_tpu_torch.tools import batch_invariance as bi

from _torch_parity import to_port_config

torch.set_num_threads(2)

KINDS = sorted(bi.CHANNELS)  # GRU2, LSTM, RNN, TRM


def _jitter(tree, rng, scale=0.05):
    """Every leaf moved off its init value (LN gains, zero biases)."""
    return jax.tree.map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("name", KINDS)
def test_channel_kernels_path_matches_plain_and_jax(tiny_model_cfg, name):
    mcfg = bi.channel_config(tiny_model_cfg, name)
    rng = np.random.default_rng(3)
    tree = _jitter(tparams.to_numpy(tparams.init_params(
        to_port_config(mcfg), seed=4)["encoder"]), rng)
    E, H = mcfg.image.input_dim, mcfg.image.hidden_dim
    topic = rng.standard_normal((6, E)).astype(np.float32)
    img, txt = (rng.standard_normal((mcfg.seq_len, 6, E)).astype(np.float32)
                for _ in range(2))
    ref = jencoder.encoder_forward(jax.tree.map(jnp.asarray, tree), mcfg,
                                   jnp.asarray(topic), jnp.asarray(img), jnp.asarray(txt))
    args = (tparams.from_jax_numpy(tree), mcfg, torch.from_numpy(topic),
            torch.from_numpy(img), torch.from_numpy(txt))
    fused_gru.fused_gru.launches = 0
    with torch.no_grad():
        kernels = encoder.encoder_forward(*args, use_kernels=True)
        plain = encoder.encoder_forward(*args, use_kernels=False)
    assert fused_gru.fused_gru.launches == 0  # the fused kernel is for 1-layer GRUs
    for k, p, r in zip(kernels, plain, ref):
        assert k.shape == p.shape and k.shape[-1] == H
        np.testing.assert_allclose(k.numpy(), p.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(k.numpy(), np.asarray(r), atol=1e-5, rtol=0)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["GRU", "LSTM", "RNN"])
def test_rnn_products_go_through_mm(kind):
    """Each layer's input projection (T·B rows) and each step's ``h @ w_hh``
    (B rows) call ``mm``: one layer's T + 1 products a layer; ``matmul`` on
    the CPU gives the plain path's bits, and the default (plain) path keeps
    its gradient."""
    tree = tparams._Init(5).rnn(kind, 12, 8, 2)
    x = torch.randn(5, 3, 12, generator=torch.Generator().manual_seed(1))
    calls = []

    def counted(a, w, bias=None):
        calls.append((tuple(a.shape), tuple(w.shape)))
        return matmul(a, w, bias)

    with torch.no_grad():
        out, fin = rnn.rnn_forward(tree, x, kind, mm=counted)
        ref, ref_fin = rnn.rnn_forward(tree, x, kind)
    G = rnn.GATES[kind] * 8
    assert calls.count(((5, 3, 12), (12, G))) == 1  # layer 0's input projection
    assert calls.count(((5, 3, 8), (8, G))) == 1    # layer 1's
    assert calls.count(((3, 8), (8, G))) == 2 * 5   # every step of both layers
    assert len(calls) == 2 * (5 + 1)
    assert torch.equal(out, ref) and torch.equal(fin, ref_fin)
    leaf = tree["layers"][0]["w_hh"].clone().requires_grad_(True)
    tree["layers"][0]["w_hh"] = leaf
    rnn.rnn_forward(tree, x, kind, mm=matmul_plain)[0].sum().backward()
    assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0)


def test_multi_layer_dropout_stays_off_at_inference(tiny_model_cfg):
    """The 2-layer GRU's inter-layer dropout: on with a generator (train),
    off without one, whatever ``use_kernels``."""
    mcfg = dataclasses.replace(bi.channel_config(to_port_config(tiny_model_cfg), "GRU2"),
                               dropout=0.5)
    p = tparams.init_params(mcfg, seed=6)["encoder"]
    E = mcfg.image.input_dim
    g = torch.Generator().manual_seed(2)
    topic, img, txt = (torch.randn(*s, generator=g) for s in
                       ((4, E), (mcfg.seq_len, 4, E), (mcfg.seq_len, 4, E)))
    with torch.no_grad():
        a = encoder.encoder_forward(p, mcfg, topic, img, txt, use_kernels=True)
        b = encoder.encoder_forward(p, mcfg, topic, img, txt, use_kernels=False)
        c = encoder.encoder_forward(p, mcfg, topic, img, txt,
                                    dropout_gen=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
