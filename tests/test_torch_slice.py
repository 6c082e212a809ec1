"""The port's generation slice vs the JAX package on the conftest tiny
config, in f32 on the CPU, with the same parameters (JAX init through
params.from_jax_numpy) and the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import decoding as jdec
from mmtg_tpu.configs import GenerateConfig, SpecialTokens
from mmtg_tpu.models import gpt2 as jgpt2
from mmtg_tpu.models import mmtg as jmmtg
from mmtg_tpu.ops import sampling as jsampling
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.models import gpt2, mmtg
from mmtg_tpu_torch.ops import prng, sampling

from _torch_parity import make_setup

torch.set_num_threads(2)
SPECIAL = SpecialTokens()


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    return make_setup(tiny_model_cfg, tiny_data_cfg, tokenizer)


def test_encode_experiences_matches_jax(setup):
    jb, tb = setup["jbatch"], setup["tbatch"]
    ref_fused, ref_kl = jmmtg.encode_experiences(
        setup["jparams"], setup["mcfg"], jb["topic_emb"], jb["img_embs"],
        jb["r_embs"])
    for use_fused_gru in (False, True):
        fused, kl = mmtg.encode_experiences(
            setup["tparams"], setup["mcfg"], tb["topic_emb"], tb["img_embs"],
            tb["r_embs"], use_fused_gru=use_fused_gru)
        np.testing.assert_allclose(fused.numpy(), np.asarray(ref_fused), atol=1e-5)
        np.testing.assert_allclose(kl.numpy(), np.asarray(ref_kl), atol=1e-5)


def test_gpt2_forward_matches_jax(setup):
    mcfg = setup["mcfg"].gpt2
    rng = np.random.default_rng(1)
    B, T = 2, 20
    x = rng.standard_normal((B, T, mcfg.n_embd)).astype(np.float32)
    types = rng.integers(0, 5, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 3:6] = 0
    ref, (rk, rv) = jgpt2.gpt2_forward(
        setup["jparams"]["gpt2"], mcfg, jnp.asarray(x), jnp.arange(T)[None],
        jnp.asarray(types), jnp.asarray(mask), return_kv=True)
    got, (k, v) = gpt2.gpt2_forward(
        setup["tparams"]["gpt2"], mcfg, torch.from_numpy(x),
        torch.arange(T)[None], torch.from_numpy(types).long(),
        torch.from_numpy(mask), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # JAX returns [L, B, H, T, hd]; the port keeps heads merged [L, B, T, D]
    L, _, H, _, hd = rk.shape
    np.testing.assert_allclose(
        k.numpy(), np.asarray(rk).transpose(0, 1, 3, 2, 4).reshape(L, B, T, H * hd),
        atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
def test_greedy_generate_matches_jax(setup, cache_dtype):
    """top_k=1 over 60 steps (past the 44-token window and the 22-token
    frames): the port's tokens equal the JAX engine's, weights resolving to
    int8 at this batch size on both sides."""
    gcfg = GenerateConfig(length=60, top_k=1, top_p=0.7, temperature=1.1,
                          repetition_penalty=1.5, cache_dtype=cache_dtype)
    ref = np.asarray(jdec.generate(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["jbatch"], jax.random.PRNGKey(0)))
    got = decoding.generate(setup["tparams"], setup["tconst"], setup["mcfg"],
                            setup["dcfg"], gcfg, setup["tbatch"],
                            torch.Generator().manual_seed(0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampled_generate_frames_and_seed(setup):
    """Default sampling: ids in range, frame tokens where
    frame_forced_token puts them, and one seed gives one output."""
    gcfg = GenerateConfig(length=46, weight_dtype="model")
    run = lambda seed: decoding.generate(  # noqa: E731
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["tbatch"], torch.Generator().manual_seed(seed)).numpy()
    toks = run(5)
    assert toks.shape == (2, 47)
    assert ((toks >= 0) & (toks < setup["mcfg"].gpt2.vocab_size)).all()
    assert (toks[:, 0] == SPECIAL.start_id).all()
    for i in range(gcfg.length):
        forced, fid = sampling.frame_forced_token(i, setup["dcfg"].sent_frame_length)
        jf, jid = jsampling.frame_forced_token(jnp.asarray(i),
                                               setup["dcfg"].sent_frame_length)
        assert (forced, fid) == (bool(jf), int(jid))
        if forced:
            assert (toks[:, i + 1] == fid).all()
    np.testing.assert_array_equal(toks, run(5))


@pytest.mark.parametrize("change", [
    dict(cache_dtype="int4"), dict(merged_kv=True), dict(attn_impl="fused"),
    dict(topk_impl="approx"),
])
def test_unported_options_raise(setup, change):
    """Approximate top-k takes the exact top-k (lax.approx_max_k off the
    TPU): the tokens of topk_impl='exact'; the int4 cache, the merged cache
    and attn_impl='fused' are ported and give frame-legal tokens."""
    gcfg = dataclasses.replace(
        GenerateConfig(length=24, cache_dtype="int8", weight_dtype="model"),
        **change)
    run = lambda: decoding.generate(  # noqa: E731
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["tbatch"], torch.Generator().manual_seed(0))
    toks = run().numpy()
    if "topk_impl" in change:
        exact = decoding.generate(
            setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"],
            dataclasses.replace(gcfg, topk_impl="exact"), setup["tbatch"],
            torch.Generator().manual_seed(0)).numpy()
        np.testing.assert_array_equal(toks, exact)
    assert toks.shape == (2, 25)
    assert (toks[:, 21] == SPECIAL.eos_id).all() and (toks[:, 22] == SPECIAL.start_id).all()


def test_row_seeds_raise(setup):
    """Per-row seeds need a threefry key (a torch.Generator is one stream for
    the whole batch) and one integer a row."""
    run = lambda generator, seeds: decoding.generate(  # noqa: E731
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"],
        GenerateConfig(length=4), setup["tbatch"], generator, row_seeds=seeds)
    with pytest.raises(ValueError):
        run(None, torch.arange(2))
    with pytest.raises(ValueError):
        run(torch.Generator().manual_seed(0), torch.arange(2))
    with pytest.raises(ValueError):
        run(prng.PRNGKey(0), torch.arange(3))
    assert run(prng.PRNGKey(0), torch.arange(2)).shape == (2, 5)


def _tf_tokens(setup, K=50):
    """[B, K] teacher-forcing tokens on the sentence frame."""
    rng = np.random.default_rng(5)
    toks = rng.integers(103, setup["mcfg"].gpt2.vocab_size, (2, K)).astype(np.int32)
    toks[:, 0] = SPECIAL.start_id
    for j in range(K):
        if j % 22 == 21:
            toks[:, j] = SPECIAL.eos_id
        elif j and j % 22 == 0:
            toks[:, j] = SPECIAL.start_id
    return toks


@pytest.mark.parametrize("change", [dict(cache_dtype="int4"),
                                    dict(cache_dtype="int8", merged_kv=True)],
                         ids=["int4", "merged"])
def test_teacher_forced_new_cache_forms_match_jax(setup, change):
    """The slice as a whole with the int4 cache and with the merged k||v
    cache vs the JAX engine on the same cache dtype: logits <= 1e-4 (f32;
    the quantized codes are equal, the attention sums in another order)."""
    gcfg = GenerateConfig(**change)
    toks = _tf_tokens(setup)
    ref = jax.jit(jdec.teacher_forced_decode_logits, static_argnums=(2, 3, 4))(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["jbatch"], jnp.asarray(toks))
    got = decoding.teacher_forced_decode_logits(
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["tbatch"], torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("seeded", [False, True], ids=["shared", "row_seeds"])
@pytest.mark.parametrize("cache_dtype", ["model", "int8", "int4"])
def test_sampled_generate_matches_jax_token_for_token(setup, seeded, cache_dtype):
    """Default sampling (top-k 10, top-p 0.7, temperature 1.1, penalty 1.5)
    from a threefry key: the port draws JAX's own bits, so in f32 the sampled
    tokens equal the JAX engine's, with one stream for the batch and with
    per-row streams."""
    gcfg = GenerateConfig(length=50, cache_dtype=cache_dtype)
    seeds = np.array([11, -4], np.int32) if seeded else None
    ref = np.asarray(jdec.generate(
        setup["jparams"], setup["jconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["jbatch"], jax.random.PRNGKey(9),
        row_seeds=None if seeds is None else jnp.asarray(seeds)))
    got = decoding.generate(
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["tbatch"], prng.PRNGKey(9),
        row_seeds=None if seeds is None else torch.from_numpy(seeds))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fused_generate_equals_per_layer_greedy(setup):
    """attn_impl='fused' through generate (on the CPU: the whole-step
    kernel's plain version) gives frame-legal tokens, equal to the per-layer
    path's greedy tokens; outside its scope (int8 weights) it resolves to the
    per-layer path."""
    base = GenerateConfig(length=46, top_k=1, cache_dtype="int8",
                          weight_dtype="model")
    run = lambda gcfg: decoding.generate(  # noqa: E731
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        setup["tbatch"]).numpy()
    fused = run(dataclasses.replace(base, attn_impl="fused"))
    np.testing.assert_array_equal(fused, run(base))
    assert (fused[:, 21] == SPECIAL.eos_id).all() and (fused[:, 22] == SPECIAL.start_id).all()
    D = setup["mcfg"].gpt2.n_embd
    resolve = lambda **kw: decoding.resolve_attn_impl(  # noqa: E731
        dataclasses.replace(base, attn_impl="fused", **kw), D, batch_size=2)
    assert resolve() == "fused"
    assert resolve(weight_dtype="int8") == "kernel"
    assert resolve(weight_dtype="auto") == "kernel"  # int8 weights at B <= 32
    assert resolve(merged_kv=True) == "kernel"
    assert resolve(cache_dtype="int4") == "kernel"
    assert resolve(cache_dtype="model") == "kernel"
    assert decoding.resolve_attn_impl(base, D, batch_size=2) == "kernel"
