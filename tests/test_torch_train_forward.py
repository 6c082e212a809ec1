"""The port's train forward (gpt2_forward with the train attention, and
mmtg_forward_train) vs the JAX package, f32 on the CPU: against the XLA
attention path and against the Pallas packed kernel in interpret mode; and
remat on = remat off, with dropout too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.models import gpt2 as jgpt2
from mmtg_tpu.models import mmtg as jmmtg
from mmtg_tpu.ops import train_attention as jta
from mmtg_tpu_torch.models import gpt2, mmtg
from mmtg_tpu_torch.params import tree_leaves

from _torch_parity import make_train_setup

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tokenizer):
    return make_train_setup(tokenizer, n=2)


@pytest.fixture
def interpret_mode():
    jta.INTERPRET = True
    yield
    jta.INTERPRET = False


def _gpt2_inputs(setup, T=40):
    rng = np.random.default_rng(1)
    D = setup["mcfg"].gpt2.n_embd
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    types = rng.integers(0, 5, (2, T)).astype(np.int32)
    mask = np.ones((2, T), np.int32)
    mask[1, 3:6] = 0
    mask[0, T - 4:] = 0
    return x, types, mask


@pytest.mark.parametrize("lm_head", [True, False])
@pytest.mark.parametrize("jimpl", ["xla", "pallas_packed"])
def test_gpt2_train_forward_matches_jax(setup, interpret_mode, jimpl, lm_head):
    x, types, mask = _gpt2_inputs(setup)
    T = x.shape[1]
    ref, _ = jgpt2.gpt2_forward(
        setup["jparams"]["gpt2"], setup["mcfg"].gpt2, jnp.asarray(x),
        jnp.arange(T)[None], jnp.asarray(types), jnp.asarray(mask),
        attn_impl=jimpl, lm_head=lm_head)
    for impl in ("plain", "kernel"):  # on the CPU the kernel wrapper is plain
        got, kv = gpt2.gpt2_forward(
            setup["tparams"]["gpt2"], setup["tmcfg"].gpt2, torch.from_numpy(x),
            torch.arange(T)[None], torch.from_numpy(types), torch.from_numpy(mask),
            attn_impl=impl, deterministic=True, lm_head=lm_head)
        assert kv is None
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_gpt2_forward_rejects_unknown_attn_impl(setup, impl):
    # no third path: the kernel pair or its plain version, nothing else
    x, types, mask = _gpt2_inputs(setup)
    with pytest.raises(ValueError):
        gpt2.gpt2_forward(setup["tparams"]["gpt2"], setup["tmcfg"].gpt2,
                          torch.from_numpy(x), torch.arange(x.shape[1])[None],
                          attn_impl=impl)


def test_gpt2_forward_prefill_has_no_dropout(setup):
    x, types, mask = _gpt2_inputs(setup)
    with pytest.raises(ValueError):
        gpt2.gpt2_forward(setup["tparams"]["gpt2"], setup["tmcfg"].gpt2,
                          torch.from_numpy(x), torch.arange(x.shape[1])[None],
                          return_kv=True, deterministic=False,
                          dropout_gen=torch.Generator().manual_seed(0))


def test_gpt2_forward_auto_reaches_the_wrapper(setup, monkeypatch):
    """``auto`` hands every layer to mha_train_packed, whatever the head
    width: nothing reroutes a shape the kernels refuse to another attention,
    the wrapper's own check raises for it."""
    from mmtg_tpu_torch.ops import train_attention as ta

    calls = []

    def spy(qkv, qkv_bias, bias, seed, n_head, rate, scale):
        calls.append(qkv.shape[-1] // (3 * n_head))
        return ta.mha_train_packed_plain(qkv, qkv_bias, bias, seed, n_head,
                                         rate, scale)

    monkeypatch.setattr(gpt2, "mha_train_packed", spy)
    cfg = setup["tmcfg"].gpt2
    x, types, mask = _gpt2_inputs(setup)
    gpt2.gpt2_forward(setup["tparams"]["gpt2"], cfg, torch.from_numpy(x),
                      torch.arange(x.shape[1])[None], attn_impl="auto")
    assert calls == [cfg.head_dim] * cfg.n_layer
    with pytest.raises(ValueError, match="head_dim 136"):
        ta._check(ta.mha_train_packed, torch.zeros(1, 128, 3 * 136), torch.zeros(3 * 136),
                  torch.zeros(1, 128), torch.zeros(1, dtype=torch.int32), 1)


@pytest.mark.parametrize("jimpl", ["xla", "pallas_packed"])
def test_mmtg_forward_train_matches_jax(setup, interpret_mode, jimpl):
    ref = jmmtg.mmtg_forward_train(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"],
        setup["jbatch"], compute_lm_loss=True, attn_impl=jimpl)
    got = mmtg.mmtg_forward_train(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
        setup["tbatch"], compute_lm_loss=True, attn_impl="plain")
    assert got.hidden is None
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), atol=1e-5)
    np.testing.assert_allclose(got.kl_per_sample.numpy(),
                               np.asarray(ref.kl_per_sample), atol=1e-6)
    assert float(got.lm_loss) == pytest.approx(float(ref.lm_loss), abs=1e-5)


def test_mmtg_forward_train_hidden_matches_jax(setup):
    ref = jmmtg.mmtg_forward_train(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"],
        setup["jbatch"], lm_head=False)
    got = mmtg.mmtg_forward_train(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
        setup["tbatch"], lm_head=False, attn_impl="kernel")
    assert got.logits is None and got.lm_loss is None
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(ref.hidden), atol=1e-5)


def _loss_and_grads(setup, remat, dropout, attn_impl="kernel"):
    params = jax.tree.map(lambda x: torch.from_numpy(np.array(x)).requires_grad_(True),
                          setup["jparams"])
    gen = torch.Generator().manual_seed(5) if dropout else None
    out = mmtg.mmtg_forward_train(
        params, setup["tconst"], setup["tmcfg"], setup["tdcfg"], setup["tbatch"],
        dropout_gen=gen, deterministic=not dropout, remat=remat,
        attn_impl=attn_impl)
    loss = out.logits.square().mean() + out.kl_per_sample.sum()
    leaves = tree_leaves(params)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
@pytest.mark.parametrize("dropout", [False, True])
def test_remat_changes_nothing(setup, dropout, attn_impl):
    loss0, g0 = _loss_and_grads(setup, False, dropout, attn_impl)
    loss1, g1 = _loss_and_grads(setup, True, dropout, attn_impl)
    assert loss0 == loss1  # the same forward, the same masks
    # the recomputed backward accumulates shared leaves (wte, the stacked
    # layers) in another order: equal to f32 rounding, not bit for bit
    for a, b in zip(g0, g1):
        scale = max(float(a.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_dropout_is_on_only_when_asked(setup):
    det, _ = _loss_and_grads(setup, False, False)
    drop, _ = _loss_and_grads(setup, False, True)
    assert det != drop
    # deterministic=True ignores the generator
    out = mmtg.mmtg_forward_train(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
        setup["tbatch"], dropout_gen=torch.Generator().manual_seed(1),
        deterministic=True, attn_impl="kernel")
    ref = mmtg.mmtg_forward_train(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
        setup["tbatch"], attn_impl="kernel")
    assert torch.equal(out.logits, ref.logits)


def test_dropout_scale_and_keep_fraction():
    x = torch.ones(64, 1024)
    y = gpt2._dropout(x, 0.1, 123)
    thr = int(round(0.1 * 65536.0))
    keep_p = (65536 - thr) / 65536.0
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1.0 / keep_p))
    n = x.numel()
    assert abs(kept.float().mean().item() - keep_p) < 4 * np.sqrt(0.09 / n)
    assert torch.equal(y, gpt2._dropout(x, 0.1, 123))  # a function of the seed
    assert not torch.equal(y, gpt2._dropout(x, 0.1, 124))
    assert gpt2._dropout(x, 0.0, 123) is x and gpt2._dropout(x, 0.1, None) is x


def test_encoder_inter_layer_dropout(setup):
    """Two-layer GRU channels: the dropout between the layers is on only
    with a generator, and is a function of the generator's state."""
    import dataclasses

    from mmtg_tpu_torch.configs import ChannelConfig
    from mmtg_tpu_torch.models.encoder import encoder_forward
    from mmtg_tpu_torch.params import init_params

    two = ChannelConfig(input_dim=64, hidden_dim=32, type="GRU", num_layers=2)
    mcfg = dataclasses.replace(setup["tmcfg"], image=two, text=two, dropout=0.5)
    enc = init_params(mcfg, seed=0)["encoder"]
    rng = np.random.default_rng(0)
    topic = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    seq = torch.from_numpy(rng.standard_normal((5, 3, 64)).astype(np.float32))

    def run(gen):
        return encoder_forward(enc, mcfg, topic, seq, seq, dropout_gen=gen)

    base = run(None)
    a = run(torch.Generator().manual_seed(1))
    b = run(torch.Generator().manual_seed(1))
    c = run(torch.Generator().manual_seed(2))
    assert torch.equal(base[0], a[0])  # the topic channel has no dropout
    for i in (1, 2):
        assert torch.equal(a[i], b[i])
        assert not torch.equal(a[i], base[i]) and not torch.equal(a[i], c[i])
    assert not torch.equal(a[1], a[2])  # the channels draw separate masks
