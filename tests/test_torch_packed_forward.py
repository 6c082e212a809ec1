"""The packed-sequence forward and losses of the port vs the JAX package's,
f32 on the CPU, on one packed batch from ``PackedBatcher`` and one parameter
tree: ``mmtg_forward_train_packed`` logits, hidden states and KL, both packed
losses against JAX's and against each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import loss as jloss
from mmtg_tpu.models import mmtg as jmmtg
from mmtg_tpu.ops import train_attention as jta
from mmtg_tpu_torch import loss as tloss
from mmtg_tpu_torch.models import mmtg

from _torch_parity import make_packed_setup

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    lens = [[int(rng.integers(2, 14)) for _ in range(10)] for _ in range(9)]
    return make_packed_setup(lens, row_len=256, max_slots=3, rows=4,
                             ratings=[5, 1, 4, 3, 2, 5, 3, 1, 4])


@pytest.fixture
def interpret_mode():
    jta.INTERPRET = True
    yield
    jta.INTERPRET = False


def test_the_packed_batch_exercises_what_it_should(setup):
    b = setup["np_packed"]
    S = b["slot_valid"].shape[1]
    assert b["tokens"].shape == (4, 256) and S == 3
    assert 0 < b["slot_valid"].sum() < b["slot_valid"].size  # live and dead slots
    assert (b["seg"] == S).any() and (b["seg"] < S).any()    # pad slots too
    assert (b["win"] == 5).any() and (b["win"] < 5).any()


@pytest.mark.parametrize("jimpl", ["xla", "pallas_packed"])
def test_packed_forward_matches_jax(setup, interpret_mode, jimpl):
    ref = jmmtg.mmtg_forward_train_packed(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"],
        setup["jpacked"], attn_impl=jimpl)
    got = mmtg.mmtg_forward_train_packed(
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
        setup["tpacked"])
    assert got.logits.shape == tuple(ref.logits.shape) == (4, 256, 200)
    assert float(np.abs(got.logits.numpy() - np.asarray(ref.logits)).max()) <= 1e-5
    assert got.kl_per_sample.shape == (4, 3)
    assert float(np.abs(got.kl_per_sample.numpy()
                        - np.asarray(ref.kl_per_sample)).max()) <= 1e-5
    assert got.lm_loss is None and got.hidden is None


def test_packed_forward_hidden_and_plain_attention(setup):
    ref = jmmtg.mmtg_forward_train_packed(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"],
        setup["jpacked"], lm_head=False)
    for impl in ("auto", "plain", "kernel_padded"):
        got = mmtg.mmtg_forward_train_packed(
            setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"],
            setup["tpacked"], lm_head=False, attn_impl=impl)
        assert got.logits is None
        assert float(np.abs(got.hidden.numpy() - np.asarray(ref.hidden)).max()) <= 1e-5


def test_a_token_sees_only_its_own_sample(setup):
    """Changing the tokens of slot 1 of row 0 leaves the logits of the other
    slots of that row as they were."""
    batch = dict(setup["tpacked"])
    run = lambda b: mmtg.mmtg_forward_train_packed(  # noqa: E731
        setup["tparams"], setup["tconst"], setup["tmcfg"], setup["tdcfg"], b).logits
    base = run(batch)
    tokens = batch["tokens"].clone()
    mine = batch["seg"][0] == 1
    assert mine.any()
    tokens[0, mine] = (tokens[0, mine] + 1) % 190 + 5
    moved = run({**batch, "tokens": tokens})
    assert float((base[0, ~mine] - moved[0, ~mine]).abs().max()) <= 1e-6
    assert float((base[0, mine] - moved[0, mine]).abs().max()) > 1e-4
    assert torch.equal(base[1:], moved[1:])


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_packed_losses_match_jax_and_each_other(setup, stage):
    rng = np.random.default_rng(stage)
    logits = rng.standard_normal((4, 256, 200)).astype(np.float32) * 2.0
    hidden = rng.standard_normal((4, 256, 128)).astype(np.float32)
    wte = rng.standard_normal((200, 128)).astype(np.float32) * 0.2
    jref = jloss.packed_sequence_unlikelihood_loss(
        jnp.asarray(logits), setup["jpacked"], jnp.asarray(stage))
    got = tloss.packed_sequence_unlikelihood_loss(
        torch.from_numpy(logits), setup["tpacked"], stage)
    for g, r in zip(got, jref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    jref_h = jloss.packed_sequence_unlikelihood_loss_from_hidden(
        jnp.asarray(hidden), jnp.asarray(wte), setup["jpacked"], jnp.asarray(stage))
    got_h = tloss.packed_sequence_unlikelihood_loss_from_hidden(
        torch.from_numpy(hidden), torch.from_numpy(wte), setup["tpacked"], stage)
    for g, r in zip(got_h, jref_h):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    full = tloss.packed_sequence_unlikelihood_loss(
        torch.from_numpy(hidden @ wte.T), setup["tpacked"], stage)
    for a, b in zip(got_h, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    # the chunked loss under autograd (checkpointed chunks) gives the same
    # gradient as the full one
    h1 = torch.from_numpy(hidden).requires_grad_(True)
    h2 = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(wte)
    g1, = torch.autograd.grad(tloss.packed_sequence_unlikelihood_loss_from_hidden(
        h1, w, setup["tpacked"], stage, chunk_size=100)[0], h1)
    g2, = torch.autograd.grad(tloss.packed_sequence_unlikelihood_loss(
        h2 @ w.T, setup["tpacked"], stage)[0], h2)
    assert float((g1 - g2).abs().max()) <= 1e-6


def test_dead_slots_stay_finite_and_weigh_nothing(setup):
    """A zero logit row makes every slot's CE small; the dead slots (ce pinned
    to 1 before the logs) must not turn the loss into NaN."""
    logits = torch.zeros(4, 256, 200)
    lab = setup["tpacked"]["labels"].long()
    logits.scatter_(-1, lab[..., None], 50.0)  # p -> 1 on every label: ce -> 0
    loss, weights, denom = tloss.packed_sequence_unlikelihood_loss(
        logits, setup["tpacked"], 3)
    assert torch.isfinite(loss)
    valid = setup["tpacked"]["slot_valid"].reshape(-1)
    assert torch.equal(weights > 0, valid > 0) and float(denom) == float(valid.sum())
    ids = tloss._packed_flat_ids(setup["tpacked"])
    assert int(ids.max()) == 4 * 3 and ids.dtype == torch.int64
