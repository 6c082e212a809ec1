"""The LSTM, RNN(relu) and TRM encoder channels of the port vs the JAX
package, f32 on the CPU, on the conftest tiny config with its image / text
channels swapped: the TRM block and the encoder <= 1e-5; the slice as a
whole (greedy tokens identical, threefry-sampled tokens identical); one
train step's loss and every gradient leaf (the tolerance of
test_torch_train_step.py); the reference .pth name map of LSTM / RNN stacks
in both directions, and the port's own train state for every channel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import decoding as jdec
from mmtg_tpu import train as jtrain
from mmtg_tpu.checkpoint import (
    export_reference_state_dict as jax_export,
    import_reference_state_dict as jax_import,
)
from mmtg_tpu.configs import GenerateConfig, TrainConfig
from mmtg_tpu.models import encoder as jencoder
from mmtg_tpu.models.mmtg import init_mmtg_params
from mmtg_tpu_torch import checkpoint as tckpt
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch import train as ttrain
from mmtg_tpu_torch.models import encoder
from mmtg_tpu_torch.ops import fused_gru, prng

from _torch_parity import (
    leaf_close,
    make_setup,
    make_train_setup,
    to_port_config,
    train_configs,
)

torch.set_num_threads(2)


def _channels(mcfg, image, text, text_layers=1):
    return dataclasses.replace(
        mcfg, image=dataclasses.replace(mcfg.image, type=image),
        text=dataclasses.replace(mcfg.text, type=text, num_layers=text_layers))


def _jitter(tree, rng, scale=0.05):
    """Every leaf moved off its init value (LN gains, zero biases), so each
    one takes part in what is compared."""
    return jax.tree.map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), tree)


def test_trm_forward_matches_jax():
    rng = np.random.default_rng(0)
    tree = _jitter(tparams.to_numpy(tparams._Init(1).trm(24, 32)), rng)
    x = rng.standard_normal((5, 3, 24)).astype(np.float32)
    ref = jencoder._trm_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = encoder._trm_forward(tparams.from_jax_numpy(tree), torch.from_numpy(x))
    assert got.shape == (5, 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # the first step attends to itself alone: later steps do not reach it
    x2 = x.copy()
    x2[3:] += 1.0
    again = encoder._trm_forward(tparams.from_jax_numpy(tree), torch.from_numpy(x2))
    np.testing.assert_array_equal(again[:3].numpy(), got[:3].numpy())
    with pytest.raises(ValueError, match="position table"):
        encoder._trm_forward(tparams.from_jax_numpy(tree), torch.zeros(33, 1, 24))


@pytest.mark.parametrize("image,text,text_layers", [
    ("LSTM", "RNN", 2), ("TRM", "LSTM", 1), ("RNN", "TRM", 1)])
def test_encoder_forward_matches_jax(tiny_model_cfg, image, text, text_layers):
    mcfg = _channels(tiny_model_cfg, image, text, text_layers)
    rng = np.random.default_rng(1)
    tree = _jitter(tparams.to_numpy(tparams.init_params(
        to_port_config(mcfg), seed=2)["encoder"]), rng)
    ref_tree = jax.eval_shape(lambda k: init_mmtg_params(k, mcfg),
                              jax.random.PRNGKey(0))["encoder"]
    assert (jax.tree.structure(ref_tree) == jax.tree.structure(tree)
            and [a.shape for a in jax.tree.leaves(ref_tree)]
            == [a.shape for a in jax.tree.leaves(tree)])
    E, H = mcfg.image.input_dim, mcfg.image.hidden_dim
    topic = rng.standard_normal((3, E)).astype(np.float32)
    img, txt = (rng.standard_normal((5, 3, E)).astype(np.float32) for _ in range(2))
    ref = jencoder.encoder_forward(jax.tree.map(jnp.asarray, tree), mcfg,
                                   jnp.asarray(topic), jnp.asarray(img),
                                   jnp.asarray(txt))
    fused_gru.fused_gru.launches = 0
    got = encoder.encoder_forward(tparams.from_jax_numpy(tree), mcfg,
                                  torch.from_numpy(topic), torch.from_numpy(img),
                                  torch.from_numpy(txt), use_kernels=True)
    assert fused_gru.fused_gru.launches == 0  # the GRU kernel is for GRUs only
    for g, r in zip(got, ref):
        assert g.shape[-1] == H
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def slices(tiny_model_cfg, tiny_data_cfg, tokenizer):
    """One setup (port init handed to both packages) per channel kind."""
    return {kind: make_setup(_channels(tiny_model_cfg, kind, kind), tiny_data_cfg,
                             tokenizer, jax_init=False)
            for kind in ("LSTM", "TRM")}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "threefry"])
@pytest.mark.parametrize("kind", ["LSTM", "TRM"])
def test_generate_matches_jax(slices, kind, sampled):
    """Greedy over 60 steps (int8 cache and weights, as resolved at B=2 on
    both sides), and default sampling from a threefry key (f32, the JAX
    engine's own bits): the port's tokens equal the JAX engine's."""
    s = slices[kind]
    gcfg = (GenerateConfig(length=50, cache_dtype="model") if sampled else
            GenerateConfig(length=60, top_k=1))
    ref = np.asarray(jdec.generate(s["jparams"], s["jconst"], s["mcfg"], s["dcfg"],
                                   gcfg, s["jbatch"], jax.random.PRNGKey(4)))
    got = decoding.generate(s["tparams"], s["tconst"], s["mcfg"], s["dcfg"], gcfg,
                            s["tbatch"], prng.PRNGKey(4) if sampled
                            else torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_train_step_loss_and_every_gradient_leaf_match_jax(tokenizer):
    """A TRM image channel and a two-layer LSTM text channel, no dropout,
    stage 3, the full loss: value <= 1e-5, every leaf <= 1e-5 of its
    largest entry."""
    mcfg = _channels(train_configs()[0], "TRM", "LSTM", 2)
    mcfg = dataclasses.replace(mcfg, dropout=0.0, gpt2=dataclasses.replace(
        mcfg.gpt2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
    s = make_train_setup(tokenizer, n=4, ratings=[5.0, 1.0, 4.0, 3.0], mcfg=mcfg)
    jt = TrainConfig(alpha=0.2, dtype="float32", remat=False, attn_impl="xla")
    tt = dataclasses.replace(to_port_config(jt), attn_impl="kernel")

    def jf(p):
        return jtrain.loss_and_metrics(p, s["jconst"], mcfg, s["dcfg"], jt,
                                       s["jbatch"], jnp.asarray(3), None, True)

    (ref_total, _), ref_g = jax.jit(jax.value_and_grad(jf, has_aux=True))(s["jparams"])
    params = tparams.tree_map(lambda x: x.clone().requires_grad_(True), s["tparams"])
    total, _ = ttrain.loss_and_metrics(params, s["tconst"], to_port_config(mcfg),
                                       s["tdcfg"], tt, s["tbatch"], 3, None, True)
    assert float(total.detach()) == pytest.approx(float(ref_total), abs=1e-5)
    grads = torch.autograd.grad(total, tparams.tree_leaves(params))
    ref_leaves = jax.tree.leaves(ref_g)
    assert len(grads) == len(ref_leaves)
    for g, r in zip(grads, ref_leaves):
        leaf_close(g.numpy(), r, 1e-5)


def test_lstm_and_rnn_pth_names_both_ways(tiny_model_cfg, tmp_path):
    """An LSTM image stack and a two-layer RNN text stack: the port's export
    is the JAX package's (names and values), each side imports the other's,
    and save / load through a .pth gives the tree back."""
    mcfg = _channels(tiny_model_cfg, "LSTM", "RNN", 2)
    p = tparams.init_params(to_port_config(mcfg), seed=4)
    ours = tckpt.export_reference_state_dict(p, mcfg)
    theirs = jax_export(jax.tree.map(np.asarray, tparams.to_numpy(p)), mcfg)
    assert sorted(ours) == sorted(theirs)
    assert ours["encoder.rnns_image.weight_ih_l0"].shape == (4 * 32, 64)
    assert ours["encoder.rnns_text.weight_hh_l1"].shape == (32, 32)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy())
    jax.tree.map(np.testing.assert_array_equal,
                 tparams.to_numpy(tckpt.import_reference_state_dict(theirs, mcfg)),
                 tparams.to_numpy(p))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(b), a),
                 tparams.to_numpy(p), jax_import(ours, mcfg))
    path = str(tmp_path / "lstm.pth")
    tckpt.save_reference_checkpoint(path, p, mcfg)
    jax.tree.map(np.testing.assert_array_equal,
                 tparams.to_numpy(tckpt.load_reference_checkpoint(path, mcfg)),
                 tparams.to_numpy(p))


def test_trm_has_no_reference_names(tiny_model_cfg):
    mcfg = _channels(tiny_model_cfg, "GRU", "TRM")
    p = tparams.init_params(to_port_config(mcfg), seed=5)
    with pytest.raises(ValueError, match="text channel is a TRM channel"):
        tckpt.export_reference_state_dict(p, mcfg)
    sd = tckpt.export_reference_state_dict(
        tparams.init_params(tiny_model_cfg, seed=5), tiny_model_cfg)
    with pytest.raises(ValueError, match="text channel is a TRM channel"):
        tckpt.import_reference_state_dict(sd, mcfg)


def test_train_state_round_trips_every_channel(tiny_model_cfg, tmp_path):
    """The port's step_*.pt carries TRM and LSTM trees (and generate's
    load_params reads them back)."""
    from mmtg_tpu_torch.generate import load_params

    mcfg = to_port_config(_channels(tiny_model_cfg, "TRM", "LSTM", 2))
    tcfg = to_port_config(TrainConfig(dtype="float32"))
    state, _ = ttrain.create_train_state(0, mcfg, tcfg, 1, 10, device="cpu")
    state = state._replace(step=3)
    path = tckpt.save_train_state(str(tmp_path / "train_state"), 3, state)
    fresh, _ = ttrain.create_train_state(1, mcfg, tcfg, 1, 10, device="cpu")
    restored, step = tckpt.restore_train_state(str(tmp_path / "train_state"), fresh)
    assert step == 3 and "pos" in restored.params["encoder"]["image"]
    assert len(restored.params["encoder"]["text"]["layers"]) == 2
    jax.tree.map(np.testing.assert_array_equal, tparams.to_numpy(restored.params),
                 tparams.to_numpy(state.params))
    jax.tree.map(np.testing.assert_array_equal,
                 tparams.to_numpy(load_params(path, mcfg)),
                 tparams.to_numpy(state.params))
