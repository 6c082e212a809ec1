"""generate_stream vs generate in the port, on the conftest tiny config on the
CPU: the blocks, concatenated, equal the one-shot tokens exactly for any
chunking, from a torch.Generator, from one threefry key and with per-row
seeds; with row_seeds a row's tokens do not depend on its batch companions."""

import numpy as np
import pytest
import torch

from mmtg_tpu.configs import GenerateConfig, SpecialTokens
from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.ops import prng

from _torch_parity import make_setup

torch.set_num_threads(2)
LENGTH = 50


@pytest.fixture(scope="module")
def setup(tiny_model_cfg, tiny_data_cfg, tokenizer):
    return make_setup(tiny_model_cfg, tiny_data_cfg, tokenizer, jax_init=False)


def _source(kind):
    if kind == "generator":
        return torch.Generator().manual_seed(3), None
    seeds = torch.tensor([5, -9]) if kind == "row_seeds" else None
    return prng.PRNGKey(3), seeds


def _args(setup, gcfg):
    return (setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
            setup["tbatch"])


@pytest.fixture(scope="module")
def one_shot(setup):
    gcfg = GenerateConfig(length=LENGTH, cache_dtype="int8")
    return {kind: decoding.generate(*_args(setup, gcfg), *_source(kind)).numpy()
            for kind in ("generator", "key", "row_seeds")}


@pytest.mark.parametrize("kind", ["generator", "key", "row_seeds"])
@pytest.mark.parametrize("chunk", [None, 22, 7, 1, 1000])
def test_stream_blocks_equal_one_shot(setup, one_shot, kind, chunk):
    gcfg = GenerateConfig(length=LENGTH, cache_dtype="int8")
    blocks = list(decoding.generate_stream(*_args(setup, gcfg), *_source(kind),
                                           chunk=chunk))
    want = 22 if chunk is None else min(chunk, LENGTH)
    assert [b.shape[1] for b in blocks[:-1]] == [want] * (len(blocks) - 1)
    assert 0 < blocks[-1].shape[1] <= want
    assert all(b.dtype == torch.int32 and b.shape[0] == 2 for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks, dim=1).numpy(),
                                  one_shot[kind][:, 1:])
    assert (one_shot[kind][:, 0] == SpecialTokens().start_id).all()


@pytest.mark.parametrize("change", [dict(cache_dtype="int4"),
                                    dict(cache_dtype="int8", merged_kv=True),
                                    dict(cache_dtype="int8", attn_impl="fused",
                                         weight_dtype="model"),
                                    dict(cache_dtype="model")],
                         ids=["int4", "merged", "fused", "fp"])
def test_stream_equals_one_shot_on_every_cache_form(setup, change):
    gcfg = GenerateConfig(length=30, **change)
    key, seeds = _source("row_seeds")
    full = decoding.generate(*_args(setup, gcfg), key, seeds)
    blocks = list(decoding.generate_stream(*_args(setup, gcfg), key, seeds, chunk=11))
    assert [b.shape[1] for b in blocks] == [11, 11, 8]
    np.testing.assert_array_equal(torch.cat(blocks, dim=1).numpy(),
                                  full[:, 1:].numpy())


def test_merged_cache_tokens_equal_split_cache_tokens(setup):
    key, seeds = _source("row_seeds")
    run = lambda merged: decoding.generate(  # noqa: E731
        *_args(setup, GenerateConfig(length=30, cache_dtype="int8",
                                     merged_kv=merged)), key, seeds).numpy()
    np.testing.assert_array_equal(run(True), run(False))


def test_row_seeds_batch_composition_invariance(setup):
    """Row 0 with seed 5 samples the same tokens alone, beside row 1, beside a
    copy of itself under another seed, and in another batch position."""
    gcfg = GenerateConfig(length=LENGTH, cache_dtype="int8", weight_dtype="model")
    batch = setup["tbatch"]
    pick = lambda idx: {k: v[idx] for k, v in batch.items()}  # noqa: E731
    run = lambda idx, seeds: decoding.generate(  # noqa: E731
        setup["tparams"], setup["tconst"], setup["mcfg"], setup["dcfg"], gcfg,
        pick(idx), prng.PRNGKey(3), torch.tensor(seeds)).numpy()
    alone = run([0], [5])[0]
    np.testing.assert_array_equal(run([0, 1], [5, -9])[0], alone)
    np.testing.assert_array_equal(run([1, 0], [77, 5])[1], alone)
    both = run([0, 0, 1], [5, 6, 5])
    np.testing.assert_array_equal(both[0], alone)
    # another seed is another stream; the same seed on another sample too
    assert (both[1] != alone).any() and (both[2] != alone).any()


def test_stream_runs_nothing_until_consumed(setup):
    """The generator does no work before its first next(), and stops early
    without error when the consumer leaves."""
    gcfg = GenerateConfig(length=LENGTH, cache_dtype="int8")
    it = decoding.generate_stream(*_args(setup, gcfg), *_source("key"))
    first = next(it)
    assert first.shape == (2, 22)
    it.close()
