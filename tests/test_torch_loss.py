"""The port's losses and curriculum masks vs the JAX package's, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import loss as jloss
from mmtg_tpu.configs import DataConfig
from mmtg_tpu_torch import loss as tloss

from _torch_parity import to_port_config

torch.set_num_threads(2)
DCFG = DataConfig()
TDCFG = to_port_config(DCFG)
RATINGS = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 3.0], np.float32)


def _inputs(V=50, D=16, seed=0):
    rng = np.random.default_rng(seed)
    B, T = len(RATINGS), DCFG.topic_prompt_length + DCFG.target_length
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    wte = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    targets = rng.integers(0, V, (B, DCFG.target_length)).astype(np.int32)
    weights = np.array([1, 0, 1, 1, 0, 1], np.float32)
    return hidden, wte, targets, weights


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_masks_match_jax(stage):
    r = jnp.asarray(RATINGS)
    np.testing.assert_array_equal(
        tloss.binarize_ratings(torch.from_numpy(RATINGS), stage).numpy(),
        np.asarray(jloss.binarize_ratings(r, jnp.asarray(stage))))
    np.testing.assert_array_equal(
        tloss.curriculum_sample_weights(torch.from_numpy(RATINGS), stage).numpy(),
        np.asarray(jloss.curriculum_sample_weights(r, jnp.asarray(stage))))


@pytest.mark.parametrize("epoch", range(5))
def test_stage_for_epoch_matches_jax(epoch):
    for cur in ((1, 3), (0, 0), (2, 2)):
        assert tloss.stage_for_epoch(epoch, cur) == jloss.stage_for_epoch(epoch, cur)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_full_loss_value_and_grad_match_jax(stage, weighted):
    hidden, wte, targets, weights = _inputs()
    logits = hidden @ wte.T
    w = weights if weighted else None

    def jf(lg):
        return jloss.sequence_unlikelihood_loss(
            lg, jnp.asarray(targets), jnp.asarray(RATINGS), jnp.asarray(stage),
            DCFG, None if w is None else jnp.asarray(w))

    ref, ref_g = jax.value_and_grad(jf)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = tloss.sequence_unlikelihood_loss(
        lg, torch.from_numpy(targets), torch.from_numpy(RATINGS), stage, TDCFG,
        None if w is None else torch.from_numpy(w))
    (g,) = torch.autograd.grad(got, lg)
    assert abs(float(got.detach()) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_from_hidden_matches_jax_and_full(stage):
    hidden, wte, targets, weights = _inputs(seed=1)

    def jf(h, e):
        return jloss.sequence_unlikelihood_loss_from_hidden(
            h, e, jnp.asarray(targets), jnp.asarray(RATINGS), jnp.asarray(stage),
            DCFG, jnp.asarray(weights))

    ref, (ref_gh, ref_gw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(wte))
    h = torch.from_numpy(hidden).requires_grad_(True)
    e = torch.from_numpy(wte).requires_grad_(True)
    args = (torch.from_numpy(targets), torch.from_numpy(RATINGS), stage, TDCFG,
            torch.from_numpy(weights))
    chunked = tloss.sequence_unlikelihood_loss_from_hidden(h, e, *args)
    gh, gw = torch.autograd.grad(chunked, (h, e))
    assert abs(float(chunked.detach()) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))
    np.testing.assert_allclose(gh.numpy(), np.asarray(ref_gh), atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ref_gw), atol=1e-5)
    # the chunked and the full path: same value, same gradients
    full = tloss.sequence_unlikelihood_loss(h @ e.T, *args)
    fh, fw = torch.autograd.grad(full, (h, e))
    assert abs(float(full.detach()) - float(chunked.detach())) <= 1e-5
    np.testing.assert_allclose(fh.numpy(), gh.numpy(), atol=1e-5)
    np.testing.assert_allclose(fw.numpy(), gw.numpy(), atol=1e-5)
    # without autograd the chunks run un-checkpointed, same value
    with torch.no_grad():
        plain = tloss.sequence_unlikelihood_loss_from_hidden(h, e, *args)
    assert float(plain) == pytest.approx(float(chunked.detach()), abs=1e-6)


def test_from_hidden_odd_chunk_size():
    hidden, wte, targets, weights = _inputs(seed=2)
    args = (torch.from_numpy(hidden), torch.from_numpy(wte), torch.from_numpy(targets),
            torch.from_numpy(RATINGS), 3, TDCFG, torch.from_numpy(weights))
    a = tloss.sequence_unlikelihood_loss_from_hidden(*args, chunk_size=44)
    b = tloss.sequence_unlikelihood_loss_from_hidden(*args, chunk_size=37)
    assert float(a) == pytest.approx(float(b), abs=1e-6)


def test_weighted_mean_matches_jax():
    v = np.array([1.0, 2.0, 4.0], np.float32)
    for w in (None, np.array([1, 0, 1], np.float32), np.zeros(3, np.float32)):
        ref = jloss.weighted_mean(jnp.asarray(v), None if w is None else jnp.asarray(w))
        got = tloss.weighted_mean(torch.from_numpy(v),
                                  None if w is None else torch.from_numpy(w))
        assert float(got) == pytest.approx(float(ref), abs=1e-6)
