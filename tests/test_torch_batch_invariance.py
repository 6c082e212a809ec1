"""Batch-composition invariance on the CPU: the decode kernels' splits are
functions of the position and the width alone (pure Python), the
batch-invariant product, prefix sum and LayerNorm equal the JAX package's on
the same numpy inputs, the service gives one (request, seed) the same tokens in every
bucket of a (1, 2, 4) menu, and the probe tool runs end to end. The card-side
checks are ``tests/test_torch_batch_invariance_cuda.py`` and ``chip_smoke.py``
phase 25."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops import sampling as jsampling
from mmtg_tpu_torch.configs import (ChannelConfig, DataConfig, GenerateConfig,
                                    GPT2Config, ModelConfig)
from mmtg_tpu_torch.ops import cumsum as cs
from mmtg_tpu_torch.ops import decode_attention as da
from mmtg_tpu_torch.ops import decode_megakernel as mk
from mmtg_tpu_torch.ops import matmul as mm
from mmtg_tpu_torch.ops import sampling
from mmtg_tpu_torch.ops.cumsum import row_cumsum, row_cumsum_plain
from mmtg_tpu_torch.ops.layer_norm import layer_norm_plain, layer_norm_rows
from mmtg_tpu_torch.ops.matmul import matmul, matmul_plain
from mmtg_tpu_torch.params import init_params
from mmtg_tpu_torch.serve import SAMPLE_KEYS, GenerationService
from mmtg_tpu_torch.tools import batch_invariance as bi

torch.set_num_threads(2)
BATCHES = (1, 8, 16, 32, 64)


def test_split_slots_depends_on_the_position_alone():
    """The decode-attention chunks: 256 slots each (one up to position 255,
    the default call), the last holding the position; no argument names the
    batch."""
    assert [da.split_slots(p) for p in (0, 235, 255, 256, 767)] == [
        (1, 256), (1, 256), (1, 256), (2, 256), (3, 256)]
    with pytest.raises(TypeError):
        da.split_slots(64 * 12, 235)  # the old (blocks, position) form


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,n_head", [(768, 12), (128, 4)])
def test_plan_is_the_same_at_every_batch(dtype, D, n_head):
    """The whole-step kernel's grid, tile widths and K ranges are one plan
    for B in {1, 8, 16, 32, 64} (and 512): each output's summation tree is
    then the same at every batch size."""
    plans = {B: mk.plan(B, D, 12, 256, n_head, dtype, 132) for B in BATCHES + (512,)}
    first = plans[1]
    for B, pl in plans.items():
        assert (pl.grid, pl.products, pl.smem, pl.wbuf) == (
            first.grid, first.products, first.smem, first.wbuf), B
        assert pl.att_items == B * n_head


# the full-width model's products (K, N): a decode step's four a layer, the
# LM head and the step embedding's two projector products
_FULL_WIDTH = {"qkv": (768, 2304), "attn_proj": (768, 768), "mlp_fc": (768, 3072),
               "mlp_proj": (3072, 768), "lm_head": (768, 13317),
               "proj_in": (2048, 512), "proj_out": (512, 768)}


def test_matmul_plan_takes_no_row_count():
    """``plan`` has no argument for the rows M (or the batch Z)."""
    mm.plan(768, 768, torch.bfloat16, 132)
    with pytest.raises(TypeError):
        mm.plan(8, 768, 768, torch.bfloat16, 132)
    with pytest.raises(TypeError):
        mm.plan(768, 768, torch.bfloat16, 132, M=8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,N", list(_FULL_WIDTH.values()) + [
    (520, 768), (3000, 768), (100, 48), (33, 200), (32, 64), (3, 512), (16, 64)])
def test_matmul_plan_ranges_partition_k_in_whole_stages(dtype, K, N):
    """The K ranges cover 0..K in order, each but the last a whole number of
    the same stages; at most 16 of them; the small path for K <= 32."""
    pl = mm.plan(K, N, dtype, 132)
    assert pl.path == ("small" if K <= mm.SMALL_K else "tiled")
    starts = [k0 for k0, _ in pl.ranges]
    ends = [k1 for _, k1 in pl.ranges]
    assert starts[0] == 0 and ends[-1] == K and starts[1:] == ends[:-1]
    assert 1 <= len(pl.ranges) <= mm.MAX_RANGES and 1 <= pl.slots <= mm.MAX_SLOTS
    if pl.path == "tiled":
        assert all((k1 - k0) == pl.spr * pl.bk for k0, k1 in pl.ranges[:-1])
        assert 0 < ends[-1] - starts[-1] <= pl.spr * pl.bk
        assert len(pl.ranges) == -(-(-(-K // pl.bk)) // pl.spr)
    if dtype == torch.float32:
        assert len(pl.ranges) == 1  # the parity path keeps one range


@pytest.mark.parametrize("name", sorted(_FULL_WIDTH))
def test_matmul_plan_fills_the_card(name):
    """Column tiles x K ranges reach the 132 SMs for every step and projector
    product at full width, in bf16, at any M."""
    K, N = _FULL_WIDTH[name]
    pl = mm.plan(K, N, torch.bfloat16, 132)
    assert -(-N // pl.bn) * len(pl.ranges) >= 132


@pytest.mark.parametrize("K,N", [(768, 768), (3072, 768), (16, 64), (3, 512)])
def test_matmul_plan_is_the_same_object_for_any_rows(K, N):
    """The wrapper's plan for x of 1 to 512 rows (and a batch of any size)
    is one object: it is read from the weight's shape and the type alone."""
    w = torch.zeros(K, N, dtype=torch.bfloat16)
    plans = {mm.plan_of(torch.zeros(M, K, dtype=torch.bfloat16), w, 132)
             for M in (1, 7, 8, 64, 65, 512)}
    wz = torch.zeros(3, K, N, dtype=torch.bfloat16)
    plans |= {mm.plan_of(torch.zeros(3, M, K, dtype=torch.bfloat16), wz, 132) for M in (1, 16)}
    assert len({id(p) for p in plans}) == 1


def test_row_cumsum_path_depends_on_the_row_length_alone():
    """A thread a row up to V = 32, a block a row past it; no argument names
    the number of rows."""
    assert [cs.path(V) for V in (1, 10, 31, 32, 33, 13317)] == [
        "short", "short", "short", "short", "long", "long"]
    with pytest.raises(TypeError):
        cs.path(64, 10)  # (rows, V)
    # the launch applies the same rule: V <= kShortV, the kernel's own constant
    src = open(os.path.join(os.path.dirname(cs.__file__), os.pardir, "csrc",
                            "row_cumsum.cu"), encoding="utf-8").read()
    assert re.search(r"constexpr int kShortV = (\d+);", src).group(1) == str(cs.SHORT_V)
    assert "if (V <= kShortV)" in src


_SHAPES = [  # (lead shape of x, K, N, weight stored as [N, K], bias)
    ((1,), 48, 144, False, True),     # the decode step's QKV, one row
    ((5,), 48, 48, False, False),     # attn_proj
    ((3, 16), 192, 48, False, False),  # the prefill's mlp_proj rows
    ((4,), 48, 200, True, False),     # the LM head: x @ wte.T
    ((6,), 256, 64, False, True),     # the projector's 2048 -> 512 (+ b), narrowed
]


@pytest.mark.parametrize("lead,K,N,trans,bias", _SHAPES)
def test_matmul_matches_jax(lead, K, N, trans, bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = (rng.standard_normal((N, K) if trans else (K, N)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32) if bias else None
    jw = jnp.asarray(w).T if trans else jnp.asarray(w)
    want = np.asarray(jnp.matmul(jnp.asarray(x), jw) + (0.0 if b is None else jnp.asarray(b)))
    tw = torch.from_numpy(w).T if trans else torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    for fn in (matmul, matmul_plain):
        got = fn(torch.from_numpy(x), tw, tb).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("R,V", [(2, 10), (3, 200)])
def test_row_cumsum_and_nucleus_match_jax(R, V):
    rng = np.random.default_rng(2)
    logits = np.sort(rng.standard_normal((R, V)).astype(np.float32), axis=-1)[:, ::-1].copy()
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = np.asarray(jnp.cumsum(jnp.asarray(probs), axis=-1))
    for fn in (row_cumsum, row_cumsum_plain):
        np.testing.assert_allclose(fn(torch.from_numpy(probs)).numpy(), want,
                                   atol=1e-5, rtol=0)
    got = sampling._nucleus_mask_sorted(torch.from_numpy(logits), 0.7).numpy()
    ref = np.asarray(jsampling._nucleus_mask_sorted(jnp.asarray(logits), 0.7))
    np.testing.assert_array_equal(got <= -1e29, ref <= -1e29)
    np.testing.assert_allclose(np.where(ref > -1e29, got, 0), np.where(ref > -1e29, ref, 0),
                               atol=1e-5)


@pytest.mark.parametrize("lead,D", [((3,), 48), ((2, 5), 32), ((4,), 768)])
def test_layer_norm_matches_jax(lead, D):
    from mmtg_tpu.models.gpt2 import _layer_norm as jax_layer_norm

    rng = np.random.default_rng(3)
    x = (rng.standard_normal(lead + (D,)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    for fn in (layer_norm_rows, layer_norm_plain):
        got = fn(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _tiny():
    mcfg = ModelConfig(
        seq_len=5, topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32, type="GRU"),
        text=ChannelConfig(input_dim=64, hidden_dim=32, type="GRU"),
        self_att_hidden_size=32, self_att_heads=4, mm_att_out_dim=64,
        gpt2=GPT2Config(vocab_size=200, n_positions=256, n_ctx=250, n_embd=48,
                        n_layer=2, n_head=4))
    return mcfg, DataConfig(wenlan_emb_size=64)


@pytest.fixture(scope="module")
def tiny_model():
    mcfg, dcfg = _tiny()
    return bi.full_size_model(3, torch.float32, "cpu", mcfg, dcfg)


def test_service_tokens_equal_across_a_1_2_4_menu(tiny_model):
    """One (request, seed) served alone (bucket 1), beside one other (bucket
    2) and beside three (bucket 4), f32: the same tokens each time. The
    menu's auto dtypes resolve once, from bucket 4 (int8 cache and
    weights), so bucket 1 decodes with them too."""
    mcfg, dcfg, params, const = tiny_model
    gen = torch.Generator().manual_seed(7)
    rows = bi.random_rows(4, mcfg, dcfg, gen, torch.float32, "cpu")
    samples = [{k: rows[k][i].numpy() for k in SAMPLE_KEYS} for i in range(4)]
    gcfg = GenerateConfig(length=44, cache_dtype="auto", weight_dtype="auto",
                          top_k=8, top_p=0.7, temperature=1.1, repetition_penalty=1.5)

    def served(n):
        svc = GenerationService(params, const, mcfg, dcfg, gcfg, buckets=(1, 2, 4),
                                max_wait_ms=2000.0 if n > 1 else 0.0, base_seed=0)
        with svc:
            futs = [svc.submit(samples[i], seed=5 if i == 0 else 50 + i) for i in range(n)]
            out = [f.result(timeout=100) for f in futs]
        st = svc.stats()
        assert st["batches"] == 1 and st["requests"] == n
        assert (svc.gcfg.cache_dtype, svc.gcfg.weight_dtype) == ("int8", "int8")
        return out[0]

    alone = served(1)
    np.testing.assert_array_equal(served(2), alone)
    np.testing.assert_array_equal(served(4), alone)


def test_probe_tool_runs_on_the_cpu(tiny_model):
    """The probe end to end at a tiny size: every decode path reports no
    differing step in f32, every op is probed, and the [library] ops are
    left out of what counts as differing."""
    args = bi.build_arg_parser().parse_args(
        ["--device", "cpu", "--dtype", "float32", "--batches", "1,2,3", "--length", "22"])
    out = bi.run(args, model=tiny_model)
    assert out["decode"] == {k: None for k in bi.PATHS}
    # B = 2 at rows 0 and 1, B = 3 at rows 0, 1 and 2
    assert all(len(r) == 5 for r in out["decode_runs"].values())
    assert {"lm_head", "lm_head [library]", "decode_block_fused", "layer_norm",
            "add_layer_norm", "add_layer_norm [library]",
            "decode_attention_int8_append", "sampling.cumsum"} <= set(out["ops"])
    assert set(out["ops_f32"]) == set(out["ops"])
    bad = bi.differing({"decode": {"x": None, "y": 3},
                        "ops": {"a [library]": {"differs": [2]}, "b": {"differs": [2]},
                                "c": {"differs": []}}})
    assert bad == {"decode": {"y": 3}, "ops": {"b": [2]}}
