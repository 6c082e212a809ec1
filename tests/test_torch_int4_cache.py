"""The int4 and merged k||v cache forms and the read-only decode attention of
the port vs the JAX package, on the CPU: the port runs its plain PyTorch
versions, the JAX side its Pallas kernels in interpret mode (``tile_t=64``,
``block_b=4``), as ``tests/test_decode_attention.py`` runs them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.models import gpt2 as jgpt2
from mmtg_tpu.ops import decode_attention as jda
from mmtg_tpu_torch.models import gpt2
from mmtg_tpu_torch.ops import decode_attention as da
from mmtg_tpu_torch.params import kv_cache_from_jax_numpy

torch.set_num_threads(2)
L, B, T, H, D = 2, 4, 128, 4, 128
KW = dict(n_head=H, block_b=4, tile_t=64, interpret=True)
POSITIONS = [0, 5, 63, 64, 127]


def _case(seed, position):
    rng = np.random.default_rng(seed)
    q, k_new, v_new = (rng.standard_normal((B, D)).astype(np.float32)
                       for _ in range(3))
    k = rng.standard_normal((L, B, T, D)).astype(np.float32)
    v = rng.standard_normal((L, B, T, D)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    mask[:, position] = 1
    return q, k_new, v_new, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 48), (4, 2, 7, 64)])
def test_quantize_rows_int4_bytes_and_scales_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30)).astype(np.float32)
    x[0, ..., 0] = 0.0
    x[-1] = 0.0  # an all-zero row: the 1e-6 floor
    jq, js = jgpt2.quantize_rows_int4(jnp.asarray(x))
    tq, ts = da.quantize_rows_int4(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.shape == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(da.unpack_int4(tq).numpy(),
                                  np.asarray(jgpt2.unpack_int4(jq)))
    codes = da.unpack_int4(tq)
    assert codes.min() >= -7 and codes.max() <= 7  # never -8
    # quantize -> unpack -> scale is within half a step of x
    err = (codes * ts[..., None] - torch.from_numpy(x)).abs()
    assert (err <= ts[..., None] * 0.5 + 1e-6).all()


@pytest.mark.parametrize("position", POSITIONS)
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_readonly_attention_matches_jax(kind, position):
    """Kernel #4's three plain versions vs decode_attention{,_int8,_int4}:
    ctx <= 2e-5 (fp) / 2e-4 (quantized: the scales fold after the per-head
    sums, in another order)."""
    q, _, _, k, v, mask = _case(position, position)
    layer = position % L
    pos, lay = jnp.asarray(position, jnp.int32), jnp.asarray(layer, jnp.int32)
    if kind == "fp":
        ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask), pos, lay, **KW)
        got = da.decode_attention(*_t(q, k, v, mask), position, layer, n_head=H)
        tol = 2e-5
    else:
        quant = jgpt2.quantize_rows if kind == "int8" else jgpt2.quantize_rows_int4
        (kq, ks), (vq, vs) = quant(jnp.asarray(k)), quant(jnp.asarray(v))
        fn = jda.decode_attention_int8 if kind == "int8" else jda.decode_attention_int4
        ref = fn(jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(mask), pos, lay, **KW)
        tfn = da.decode_attention_int8 if kind == "int8" else da.decode_attention_int4
        got = tfn(*_t(q, kq, vq, ks, vs, mask), position, layer, n_head=H)
        tol = 2e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=0)


@pytest.mark.parametrize("position", POSITIONS)
def test_int4_append_matches_jax(position):
    """Kernel #5's plain version vs decode_attention_int4_append: ctx <= 2e-4,
    the appended bytes equal, the scales to rtol 1e-6, nothing else written."""
    q, k_new, v_new, k, v, mask = _case(10 + position, position)
    layer = position % L
    (kq, ks), (vq, vs) = (jgpt2.quantize_rows_int4(jnp.asarray(a)) for a in (k, v))
    tk, tv, tks, tvs = _t(kq, vq, ks, vs)
    before = [t.clone() for t in (tk, tv, tks, tvs)]
    ref, rk, rv, rks, rvs = jda.decode_attention_int4_append(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.array(kq),
        jnp.array(vq), jnp.array(ks), jnp.array(vs), jnp.asarray(mask),
        jnp.asarray(position, jnp.int32), jnp.asarray(layer, jnp.int32),
        sub_tiles=4, **KW)
    got = da.decode_attention_int4_append(*_t(q, k_new, v_new), tk, tv, tks, tvs,
                                          torch.from_numpy(mask), position, layer,
                                          n_head=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(tks.numpy(), np.asarray(rks), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(rvs), rtol=1e-6, atol=0)
    for now, was in zip((tk, tv, tks, tvs), before):
        changed = (now != was)
        changed[layer, :, position] = False
        assert not changed.any()
    # the read-only version on the cache just written: the same context
    again = da.decode_attention_int4(torch.from_numpy(q), tk, tv, tks, tvs,
                                     torch.from_numpy(mask), position, layer, n_head=H)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("position", POSITIONS)
def test_merged_append_matches_jax_and_split(position):
    """Kernel #6's plain version vs decode_attention_int8_append_merged: ctx
    <= 2e-4, bytes equal, scales rtol 1e-6 — and, inside the port, the merged
    layout equals the split one bit for bit."""
    q, k_new, v_new, k, v, mask = _case(20 + position, position)
    layer = position % L
    (kq, ks), (vq, vs) = (jgpt2.quantize_rows(jnp.asarray(a)) for a in (k, v))
    kv = jnp.concatenate([kq, vq], axis=-1)
    ref, rkv, rks, rvs = jda.decode_attention_int8_append_merged(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.array(kv),
        jnp.array(ks), jnp.array(vs), jnp.asarray(mask),
        jnp.asarray(position, jnp.int32), jnp.asarray(layer, jnp.int32),
        sub_tiles=4, **KW)
    tkv, tks, tvs = _t(kv, ks, vs)
    args = _t(q, k_new, v_new)
    got = da.decode_attention_int8_append_merged(
        *args, tkv, tks, tvs, torch.from_numpy(mask), position, layer, n_head=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(rkv))
    np.testing.assert_allclose(tks.numpy(), np.asarray(rks), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(rvs), rtol=1e-6, atol=0)
    sk, sv, sks, svs = _t(kq, vq, ks, vs)
    split = da.decode_attention_int8_append(*args, sk, sv, sks, svs,
                                            torch.from_numpy(mask), position, layer,
                                            n_head=H)
    assert torch.equal(split, got)
    assert torch.equal(tkv[..., :D], sk) and torch.equal(tkv[..., D:], sv)
    assert torch.equal(tks, sks) and torch.equal(tvs, svs)


@pytest.mark.parametrize("cache_dtype", ["model", "int8", "int4"])
def test_init_and_prefill_cache_forms_match_jax(cache_dtype):
    from mmtg_tpu.configs import GPT2Config

    from _torch_parity import to_port_config

    cfg = GPT2Config(vocab_size=120, n_positions=64, n_ctx=64, n_embd=64,
                     n_layer=2, n_head=4)
    jc = jgpt2.init_cache(cfg, 3, 32, jnp.float32, quantized=cache_dtype)
    tc = gpt2.init_cache(to_port_config(cfg), 3, 32, torch.float32, cache_dtype)
    assert tc.kind(cfg.n_embd) == cache_dtype and not tc.merged
    for a, b in zip(jc, tc):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) in str(b.dtype)
    # the bridge: a JAX cache as numpy arrays, the merged sentinel included
    back = kv_cache_from_jax_numpy(*[None if a is None else np.asarray(a) for a in jc])
    assert back.kind(cfg.n_embd) == cache_dtype
    if cache_dtype == "int8":
        merged = kv_cache_from_jax_numpy(
            np.concatenate([np.asarray(jc.k), np.asarray(jc.v)], -1),
            np.zeros((0,), np.int8), np.asarray(jc.k_scale), np.asarray(jc.v_scale))
        assert merged.merged and merged.v is None
        assert merged.k.shape == gpt2.merge_kv(tc).k.shape
        with pytest.raises(ValueError):
            gpt2.merge_kv(merged)
    # prefill: the prompt's rows are quantized as JAX quantizes them
    from mmtg_tpu_torch.params import from_jax_numpy
    import jax

    jp = jgpt2.init_gpt2_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, cfg.n_embd)).astype(np.float32)
    types = rng.integers(0, 5, (3, 9)).astype(np.int32)
    mask = np.ones((3, 9), np.int32)
    _, jcache = jgpt2.prefill_cache(jp, cfg, jnp.asarray(x), jnp.arange(9)[None],
                                    jnp.asarray(types), jnp.asarray(mask), 32,
                                    quantized=cache_dtype)
    _, tcache = gpt2.prefill_cache(from_jax_numpy(jp), to_port_config(cfg),
                                   torch.from_numpy(x), torch.arange(9),
                                   torch.from_numpy(types).long(),
                                   torch.from_numpy(mask), 32, cache_dtype)
    if cache_dtype == "model":
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
    else:
        # a value on a rounding boundary may land one code apart
        kq = (gpt2.unpack_int4(tcache.k).numpy(), np.asarray(jgpt2.unpack_int4(jcache.k))) \
            if cache_dtype == "int4" else (tcache.k.numpy().astype(np.int32),
                                           np.asarray(jcache.k).astype(np.int32))
        assert np.abs(kq[0] - kq[1]).max() <= 1
        np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jcache.k_scale),
                                   rtol=1e-5, atol=1e-8)
