"""The port's sampling ops vs :mod:`mmtg_tpu.ops.sampling` and the JAX
postprocessing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import decoding as jdec
from mmtg_tpu.configs import SpecialTokens
from mmtg_tpu.ops import sampling as jsampling
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.ops import sampling

torch.set_num_threads(2)
SPECIAL = SpecialTokens()


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (10, 0.7), (3, 0.99)])
def test_filter_matches_jax(top_k, top_p):
    logits = np.random.default_rng(top_k).standard_normal((3, 50)).astype(np.float32) * 3
    ref = np.asarray(jsampling.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p))
    got = sampling.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got > -1e29, ref > -1e29)
    np.testing.assert_allclose(got[got > -1e29], ref[ref > -1e29], rtol=1e-6)


def test_repetition_penalty_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 120)).astype(np.float32)
    counts = rng.integers(0, 4, (2, 120)).astype(np.int16)
    ref = jsampling.apply_repetition_penalty(jnp.asarray(logits),
                                             jnp.asarray(counts), 1.5)
    seen = torch.from_numpy(counts)
    got = sampling.apply_repetition_penalty(torch.from_numpy(logits), seen, 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_array_equal(seen.numpy(), counts)  # input untouched


def test_draw_follows_the_distribution():
    """Gumbel-max draws: empirical frequencies match softmax(logits)."""
    N, V = 20000, 120
    logits = torch.full((N, V), -1e30)
    logits[:, 3:6] = torch.tensor([0.0, 1.0, 2.0])
    g = torch.Generator().manual_seed(0)
    toks = sampling.sample_next_token(g, logits, torch.zeros(N, V),
                                      torch.ones(N, dtype=torch.int32))
    freq = np.bincount(toks.numpy(), minlength=V) / N
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.015)


def test_postprocess_matches_jax(tokenizer):
    ids = [SPECIAL.start_id, 800, 801, SPECIAL.eos_id, SPECIAL.start_id, 0,
           802, SPECIAL.eos_id, SPECIAL.sep_id, 803]
    assert decoding.postprocess_tokens(ids, tokenizer) == \
        jdec.postprocess_tokens(ids, tokenizer)


def test_frame_forced_token_matches_jax():
    for i in range(90):
        ref_forced, ref_id = jsampling.frame_forced_token(jnp.asarray(i), 22)
        assert sampling.frame_forced_token(i, 22) == (bool(ref_forced), int(ref_id))


def test_pad_begets_pad():
    logits = torch.zeros(2, 120)
    last = torch.tensor([SPECIAL.pad_id, 5], dtype=torch.int32)
    tok = sampling.sample_next_token(torch.Generator().manual_seed(0), logits,
                                     torch.zeros(2, 120, dtype=torch.int16),
                                     last, top_k=3)
    assert int(tok[0]) == SPECIAL.pad_id and int(tok[1]) != SPECIAL.pad_id


@pytest.mark.parametrize("per_row", [False, True], ids=["one_key", "per_row_keys"])
def test_approx_topk_matches_jax(per_row):
    """topk_impl="approx" against JAX's lax.approx_max_k on the CPU, where it
    computes the exact top-k: f32 logits [64, 13317], top-k 10, top-p 0.7,
    the same threefry key: the same tokens."""
    import jax

    from mmtg_tpu_torch.ops import prng

    rng = np.random.default_rng(5)
    B, V = 64, 13317
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    seen = rng.integers(0, 3, (B, V)).astype(np.int16)
    last = rng.integers(1, 100, B).astype(np.int32)
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    if per_row:
        jk = jax.vmap(lambda s: jax.random.fold_in(jk, s))(jnp.arange(B))
        tk = prng.fold_in(tk, torch.arange(B))
    kw = dict(temperature=1.1, top_k=10, top_p=0.7, repetition_penalty=1.5,
              topk_impl="approx", per_row_keys=per_row)
    ref = jsampling.sample_next_token(jk, jnp.asarray(logits), jnp.asarray(seen),
                                      jnp.asarray(last), **kw)
    got = sampling.sample_next_token(tk, torch.from_numpy(logits),
                                     torch.from_numpy(seen), torch.from_numpy(last),
                                     **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    exact = sampling.sample_next_token(tk, torch.from_numpy(logits),
                                       torch.from_numpy(seen), torch.from_numpy(last),
                                       **dict(kw, topk_impl="exact"))
    np.testing.assert_array_equal(got.numpy(), exact.numpy())


def test_unknown_topk_impl_raises():
    with pytest.raises(ValueError, match="topk_impl"):
        sampling.sample_next_token(None, torch.zeros(2, 50), torch.zeros(2, 50),
                                   torch.ones(2, dtype=torch.int32), top_k=3,
                                   topk_impl="sorted")
