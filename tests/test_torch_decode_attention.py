"""Port's decode-attention append (plain PyTorch version, as run for CPU
tensors) vs the JAX Pallas kernels in interpret mode, at the shapes of
tests/test_decode_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu.ops.decode_attention import (
    decode_attention_fp_append as jax_fp_append,
    decode_attention_int8_append as jax_int8_append,
)
from mmtg_tpu_torch.ops.decode_attention import (
    decode_attention_append_plain,
    decode_attention_fp_append,
    decode_attention_int8_append,
    quantize_rows,
)

torch.set_num_threads(2)

L, B, T, NH, HD = 3, 8, 256, 4, 32
D = NH * HD
LAYER = 1
KERNEL_ARGS = dict(n_head=NH, block_b=4, tile_t=64, interpret=True)


def _inputs(seed, int8):
    rng = np.random.default_rng(seed)
    q, k_new, v_new = (rng.standard_normal((B, D)).astype(np.float32)
                       for _ in range(3))
    mask = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask[:, 0] = 1
    if int8:
        kc = rng.integers(-127, 128, (L, B, T, D)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, B, T, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (L, B, T)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (L, B, T)).astype(np.float32)
        return q, k_new, v_new, mask, [kc, vc, ks, vs]
    kc = rng.standard_normal((L, B, T, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, T, D)).astype(np.float32)
    return q, k_new, v_new, mask, [kc, vc]


def _run_jax(int8, q, k_new, v_new, mask, caches, position):
    args = [jnp.asarray(x) for x in (q, k_new, v_new)]
    args += [jnp.asarray(c) for c in caches]
    fn = jax_int8_append if int8 else jax_fp_append
    out = fn(*args, jnp.asarray(mask), jnp.asarray(position, jnp.int32),
             jnp.asarray(LAYER, jnp.int32), **KERNEL_ARGS)
    return [np.asarray(o) for o in out]  # ctx, caches...


def _run_port(int8, q, k_new, v_new, mask, caches, position):
    t = [torch.from_numpy(x.copy()) for x in (q, k_new, v_new)]
    tc = [torch.from_numpy(c.copy()) for c in caches]
    tm = torch.from_numpy(mask)
    if int8:
        ctx = decode_attention_int8_append(*t, *tc, tm, position, LAYER,
                                           n_head=NH)
    else:
        ctx = decode_attention_fp_append(*t, *tc, tm, position, LAYER,
                                         n_head=NH)
    return [ctx.numpy()] + [c.numpy() for c in tc]


@pytest.mark.parametrize("position", [0, 5, 63, 64, 200, 255])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_append_matches_jax_kernel(position, int8):
    inputs = _inputs(position + 7 * int8, int8)
    ref = _run_jax(int8, *inputs, position)
    got = _run_port(int8, *inputs, position)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5, rtol=0)
    if not int8:
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g, r)
        return
    kc, vc, ks, vs = got[1:]
    rkc, rvc, rks, rvs = ref[1:]
    for g, r in ((kc, rkc), (vc, rvc)):
        diff = np.abs(g.astype(np.int32) - r.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(ks, rks, rtol=1e-6, atol=0)
    np.testing.assert_allclose(vs, rvs, rtol=1e-6, atol=0)
    # only slot `position` of layer LAYER was written
    _, _, _, _, before = inputs
    untouched = np.ones((L, B, T), bool)
    untouched[LAYER, :, position] = False
    np.testing.assert_array_equal(kc[untouched], before[0][untouched])
    np.testing.assert_array_equal(ks[untouched], before[2][untouched])


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_ignores_garbage_beyond_position(int8):
    """Slots past `position` never change ctx, even holding huge values."""
    q, k_new, v_new, mask, caches = _inputs(3, int8)
    pos = 30
    clean = _run_port(int8, q, k_new, v_new, mask, caches, pos)[0]
    dirty_caches = [c.copy() for c in caches]
    big = 127 if int8 else 1e4
    dirty_caches[0][:, :, pos + 1:] = big
    dirty_caches[1][:, :, pos + 1:] = -big
    if int8:
        dirty_caches[2][:, :, pos + 1:] = 1e4
        dirty_caches[3][:, :, pos + 1:] = 1e4
    dirty = _run_port(int8, q, k_new, v_new, mask, dirty_caches, pos)[0]
    np.testing.assert_array_equal(clean, dirty)


def test_quantize_rows_matches_jax():
    from mmtg_tpu.models.gpt2 import quantize_rows as jax_quantize_rows

    x = np.random.default_rng(5).standard_normal((4, 6, D)).astype(np.float32)
    x[0, 0] = 0.0  # the 1e-6 scale floor
    q, s = quantize_rows(torch.from_numpy(x))
    rq, rs = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_bf16_plain_prescales_q_in_bf16():
    """The plain version rounds q * 1/sqrt(hd) back to bf16 before the
    score dot, as the TPU wrapper does; with an f32 cache of the same
    values the two dtypes then agree to bf16 precision."""
    q, k_new, v_new, mask, caches = _inputs(11, False)
    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k_new, v_new)]
    tc = [torch.from_numpy(c).to(torch.bfloat16) for c in caches]
    ctx = decode_attention_append_plain(*tq, *tc, torch.from_numpy(mask),
                                        90, LAYER, NH)
    assert ctx.dtype == torch.bfloat16
    f32 = [t.float() for t in tq]
    ref = decode_attention_append_plain(*f32, *[c.float() for c in tc],
                                        torch.from_numpy(mask), 90, LAYER, NH)
    np.testing.assert_allclose(ctx.float().numpy(), ref.numpy(), atol=2e-2)


# ---- the CUDA kernel's launch plan (csrc/decode_attention.cu) ---------------

PLAN_CASES = [  # (kind, merged, n_head, head_dim): every cache kind and int4 path
    ("fp", False, 12, 64), ("int8", False, 12, 64), ("int8", True, 12, 64),
    ("int4", False, 12, 64), ("int4", False, 3, 64), ("fp", False, 6, 64)]


def _captured_launch(monkeypatch, kind, merged, n_head, hd, B, position,
                     append):
    """Run the wrapper's launch on meta tensors of batch ``B`` against a
    stand-in library; returns what it handed the C entry point."""
    import contextlib
    import types

    from mmtg_tpu_torch.kernels import _build
    from mmtg_tpu_torch.ops import decode_attention as da

    seen = {}

    def entry(*a):
        seen["args"] = a
        return 0

    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        mmtg_decode_attention=entry))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(da, "_counters", {})
    sizes = []  # the f32 scratch and the int32 counts the launch made
    empty, zeros = torch.empty, torch.zeros

    def spy(make):
        def made(*shape, **kw):
            out = make(*shape, **kw)
            if kw.get("dtype") in (torch.float32, torch.int32):
                sizes.append((kw["dtype"], out.numel()))
            return out
        return made

    monkeypatch.setattr(torch, "empty", spy(empty))
    monkeypatch.setattr(torch, "zeros", spy(zeros))
    D, T = n_head * hd, position + 1
    meta = dict(device="meta")
    q = torch.empty(B, D, dtype=torch.bfloat16, **meta)
    row = {"fp": D, "int8": 2 * D if merged else D, "int4": D // 2}[kind]
    cdt = torch.bfloat16 if kind == "fp" else torch.int8
    k = torch.empty(1, B, T, row, dtype=cdt, **meta)
    v = None if merged else torch.empty(1, B, T, row, dtype=cdt, **meta)
    scales = (None, None) if kind == "fp" else tuple(
        torch.empty(1, B, T, dtype=torch.float32, **meta) for _ in range(2))
    mask = torch.empty(B, T, dtype=torch.int32, **meta)
    new = (q, q) if append else (None, None)
    sizes.clear()
    da._launch(kind, q, *new, k, v, *scales, mask, position, 0, n_head)
    a = seen["args"]
    scratch = [n for t, n in sizes if t == torch.float32]
    counts = [n for t, n in sizes if t == torch.int32]
    return dict(B=a[11], n_split=a[22], chunk=a[23], pair=a[24],
                scratch=scratch[0] if scratch else None,
                counts=counts[0] if counts else None)


@pytest.mark.parametrize("position", [17, 126, 235, 300])
@pytest.mark.parametrize("kind,merged,n_head,hd", PLAN_CASES)
def test_launch_plan_depends_on_the_position_and_kind_alone(
        monkeypatch, kind, merged, n_head, hd, position):
    """The wrapper hands the kernel one plan (chunks, int4 path, partial sums
    a row) at B = 1 and at B = 4096: a row's summation tree is the same at
    any batch size. Partial sums and counts scale with B alone."""
    from mmtg_tpu_torch.ops import decode_attention as da

    for append in ((True,) if merged else (False, True)):
        one, wide = (_captured_launch(monkeypatch, kind, merged, n_head, hd, B,
                                      position, append) for B in (1, 4096))
        assert (one["B"], wide["B"]) == (1, 4096)
        assert ((one["n_split"], one["chunk"], one["pair"])
                == (wide["n_split"], wide["chunk"], wide["pair"]))
        assert one["pair"] == int(kind == "int4" and da.int4_pairs(n_head, hd))
        # chunks of 256 slots, the last holding `position`
        assert one["n_split"] == position // 256 + 1 and one["chunk"] == 256
        if one["n_split"] == 1:
            assert one["scratch"] is wide["scratch"] is None
        else:
            per_row = one["n_split"] * n_head * (hd + 2)
            assert (one["scratch"], wide["scratch"]) == (per_row, 4096 * per_row)
            assert wide["counts"] >= 4096 * n_head  # a count a (row, head)


def test_launch_plan_takes_no_batch():
    import inspect

    from mmtg_tpu_torch.ops import decode_attention as da

    assert list(inspect.signature(da.split_slots).parameters) == ["position"]
    assert [da.split_slots(p) for p in (0, 235, 255, 256, 300, 511)] == [
        (1, 256), (1, 256), (1, 256), (2, 256), (2, 256), (2, 256)]


def test_every_kernel_name_is_read_by_the_roofline_metric():
    """Every ``__global__`` function of csrc/decode_attention.cu matches the
    kernel pattern of h100bench/metrics/decode_attn_roofline.py (read as
    text), so the benchmark's reading cannot fall silent."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "h100bench", "metrics",
                           "decode_attn_roofline.py")) as f:
        metric = f.read()
    m = re.search(r'KERNEL = re\.compile\(r"([^"]+)", re\.I\)', metric)
    assert m, "the metric's kernel pattern moved"
    kernel = re.compile(m.group(1), re.I)
    with open(os.path.join(root, "mmtg_tpu_torch", "csrc",
                           "decode_attention.cu")) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       src)
    assert names and src.count("__global__") == len(names)
    assert all(kernel.search(n) for n in names), names
