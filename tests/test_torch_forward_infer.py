"""The port's no-cache inference forward, ``mmtg_forward_infer``, vs the JAX
package's in f32 on the CPU (logits <= 1e-5 under both type-id schemes),
and the port's KV-cached ``generate`` against a no-cache decode loop over
the port's ``mmtg_forward_infer``: the same tokens, as
``tests/test_decoding.py`` shows for the JAX engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.configs import GenerateConfig, SpecialTokens
from mmtg_tpu.models import mmtg as jmmtg
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.models import mmtg
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.ops.sampling import frame_forced_token, sample_next_token

from _torch_parity import make_setup

torch.set_num_threads(2)
SPECIAL = SpecialTokens()


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    return make_setup(tiny_model_cfg, tiny_data_cfg, tokenizer)


@pytest.mark.parametrize("K", [1, 30, 130])
@pytest.mark.parametrize("scheme", ["train", "reference_infer"])
def test_forward_infer_matches_jax(setup, scheme, K):
    """Prefixes of the dataset's targets (PAD slots inside them, so the pad
    mask matters; K=130 crosses the 128-token padding of the attention);
    the port's default attention and its plain version agree too."""
    targets = np.array(setup["targets"][:, :K])
    targets[1, K // 2:] = SPECIAL.pad_id  # a row that ends early
    jb = dict(setup["jbatch"], targets=jnp.asarray(targets))
    tb = dict(setup["tbatch"], targets=torch.from_numpy(targets))
    ref = jmmtg.mmtg_forward_infer(setup["jparams"], setup["jconst"], setup["mcfg"],
                                   setup["dcfg"], jb, type_id_scheme=scheme)
    for impl in ("auto", "plain"):
        got = mmtg.mmtg_forward_infer(setup["tparams"], setup["tconst"],
                                      setup["mcfg"], setup["dcfg"], tb,
                                      type_id_scheme=scheme, attn_impl=impl)
        assert got.logits.shape == (2, 15 + K, setup["mcfg"].gpt2.vocab_size)
        np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.kl_per_sample.numpy(),
                                   np.asarray(ref.kl_per_sample), atol=1e-5)


def _no_cache_decode(setup, gcfg, key):
    """Re-forward the whole prefix for every token through
    ``mmtg_forward_infer``, drawing from ``fold_in(key, step)`` as the cached
    engine does."""
    tb, mcfg, dcfg = setup["tbatch"], setup["mcfg"], setup["dcfg"]
    B, V = tb["topic_ids"].shape[0], mcfg.gpt2.vocab_size
    tokens = torch.zeros(B, gcfg.length + 1, dtype=torch.int32)
    tokens[:, 0] = SPECIAL.start_id
    seen = torch.zeros(B, V, dtype=torch.int32)
    seen[:, SPECIAL.start_id] = 1
    for i in range(gcfg.length):
        forced, fid = frame_forced_token(i, dcfg.sent_frame_length)
        if forced:
            tok = torch.full((B,), fid, dtype=torch.int32)
        else:
            out = mmtg.mmtg_forward_infer(
                setup["tparams"], setup["tconst"], mcfg, dcfg,
                dict(tb, targets=tokens[:, :i + 1]), gcfg.type_id_scheme)
            tok = sample_next_token(
                prng.fold_in(key, i), out.logits[:, -1], seen, tokens[:, i],
                temperature=gcfg.temperature, top_k=gcfg.top_k, top_p=gcfg.top_p,
                repetition_penalty=gcfg.repetition_penalty)
        tokens[:, i + 1] = tok
        seen[torch.arange(B), tok.long()] += 1
    return tokens


@pytest.mark.parametrize("scheme", ["train", "reference_infer"])
def test_cached_generate_equals_a_no_cache_loop(setup, scheme):
    """Full-precision weights and cache (the cached engine's int8 forms
    round where the full forward does not), sampled from a threefry key:
    token for token over 46 steps (two sentence frames and more)."""
    gcfg = GenerateConfig(length=46, top_k=8, top_p=0.7, temperature=1.1,
                          repetition_penalty=1.5, weight_dtype="model",
                          cache_dtype="model", type_id_scheme=scheme)
    key = prng.PRNGKey(11)
    fast = decoding.generate(setup["tparams"], setup["tconst"], setup["mcfg"],
                             setup["dcfg"], gcfg, setup["tbatch"], key)
    slow = _no_cache_decode(setup, gcfg, key)
    np.testing.assert_array_equal(fast.numpy(), slow.numpy())
