"""Single-query decode attention over the KV cache, with or without the fused
append of the step's k/v row.

PyTorch counterpart of :mod:`mmtg_tpu.ops.decode_attention` (seven wrappers
over one parameterized Pallas kernel, ``decode_attention_unified.py``: cache
kind fp / int8 / int4, append stage on or off, merged k‖v layout). The ``*_append``
wrappers write the step's k/v row into slot ``position`` of layer ``layer``
of the cache IN PLACE (the TPU version aliases its cache buffers the same
way) and return the attention context ``[B, D]`` over the live prefix:
slots ``t <= position`` with ``key_mask[b, t] != 0``. The read-only
wrappers (:func:`decode_attention`, :func:`decode_attention_int8`,
:func:`decode_attention_int4`) attend without writing; they are the oracles
the append kernels are held against.

For CUDA tensors every wrapper launches the hand-written kernel
``csrc/decode_attention.cu`` (one kernel, the same options as build flags;
a block per few heads of a batch row and chunk of its slots, the chunks
set by the position alone, :func:`split_slots`, so a row's context has the
same bits whatever the batch size);
for CPU tensors it runs the plain PyTorch version
(:func:`decode_attention_append_plain` / :func:`decode_attention_plain`).
Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from mmtg_tpu_torch.kernels import _build

NEG_INF = -1e30


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division. (PyTorch's CUDA kernel turns
    a division by a Python scalar into a multiply by its reciprocal, which
    can differ in the last bit from JAX and from the CUDA kernel.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis
    (``mmtg_tpu.models.gpt2.quantize_rows``): ``scale = max(max|x|, 1e-6) /
    127``, ``q = clip(round_half_even(x / scale), -127, 127)``.

    Returns (values int8 ``[...]``, scales f32 ``[...-1 dims]``)."""
    xf = x.float()
    scale = true_div(xf.abs().amax(dim=-1).clamp_min(1e-6), 127.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_rows_int4(x: torch.Tensor):
    """Symmetric per-row int4 quantization, two codes a byte
    (``mmtg_tpu.models.gpt2.quantize_rows_int4``): ``scale = max(max|x|,
    1e-6) / 7``, codes in [-7, 7]; packed byte ``j`` holds lane ``j`` in its
    low nibble and lane ``j + D/2`` in its high nibble.

    Returns (packed int8 ``[..., D/2]``, scales f32 ``[...-1 dims]``)."""
    xf = x.float()
    scale = true_div(xf.abs().amax(dim=-1).clamp_min(1e-6), 7.0)
    q = torch.round(xf / scale[..., None]).clamp(-7, 7).to(torch.int32)
    half = x.shape[-1] // 2
    byte = ((q[..., half:] & 15) << 4) | (q[..., :half] & 15)  # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows_int4`'s packing (the values still need
    the scale): ``[..., D/2]`` int8 → ``[..., D]`` f32."""
    p32 = packed.to(torch.int32)
    lo = ((p32 & 15) ^ 8) - 8  # sign-extended low nibble
    hi = p32 >> 4  # arithmetic shift: signed high nibble
    return torch.cat([lo, hi], dim=-1).float()


def _cache_kind(q, k_cache, k_scale, merged: bool) -> str:
    """The cache kind, as the JAX decode step tells it: no scales → fp;
    scales and a row of D/2 bytes → int4; else int8."""
    if k_scale is None:
        return "fp"
    if not merged and k_cache.shape[-1] * 2 == q.shape[-1]:
        return "int4"
    return "int8"


def _attend_plain(q, k_rows, v_rows, key_mask, position: int, n_head: int,
                  kind: str, k_scale=None, v_scale=None) -> torch.Tensor:
    """q ``[B, D]`` against one layer's stored rows ``[B, T, row]``."""
    B, D = q.shape
    hd = D // n_head
    W = position + 1  # slots past `position` are never read
    k, v = k_rows[:, :W], v_rows[:, :W]
    if kind == "int4":
        k, v = unpack_int4(k), unpack_int4(v)
    # q pre-scaled and rounded back to its dtype, as the TPU wrapper does
    qs = (q * (1.0 / math.sqrt(hd))).to(q.dtype).float().view(B, n_head, hd)
    s = torch.einsum("bhd,bthd->bht", qs, k.float().view(B, W, n_head, hd))
    if kind != "fp":
        s = s * k_scale[:, :W][:, None, :]
    s = s + ((1.0 - key_mask[:, :W].float()) * NEG_INF)[:, None, :]
    p = torch.softmax(s, dim=-1)
    if kind != "fp":
        p = p * v_scale[:, :W][:, None, :]
    ctx = torch.einsum("bht,bthd->bhd", p, v.float().view(B, W, n_head, hd))
    return ctx.reshape(B, D).to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, key_mask, position: int,
                           layer: int, n_head: int, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the read-only kernel (any device), for the fp
    cache (no scales), the int8 cache and the int4 cache (rows of D/2
    bytes)."""
    kind = _cache_kind(q, k_cache, k_scale, False)
    scales = () if kind == "fp" else (k_scale[layer], v_scale[layer])
    return _attend_plain(q, k_cache[layer], v_cache[layer], key_mask, position,
                         n_head, kind, *scales)


def decode_attention_append_plain(q, k_new, v_new, k_cache, v_cache, key_mask,
                                  position: int, layer: int, n_head: int,
                                  k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the append kernel (any device). With
    ``k_scale`` / ``v_scale`` the cache is quantized — int8, or int4 when its
    rows are D/2 bytes — and the row is quantized first; otherwise the row is
    stored in the cache's dtype. ``v_cache=None`` marks the merged layout:
    ``k_cache`` is then the ``[L, B, T, 2D]`` int8 k‖v buffer. Caches are
    updated in place."""
    D = q.shape[-1]
    merged = v_cache is None
    kind = _cache_kind(q, k_cache, k_scale, merged)
    if merged:
        if kind != "int8":
            raise ValueError("decode attention: the merged cache is int8 only")
        k_cache, v_cache = k_cache[..., :D], k_cache[..., D:]
    if kind == "fp":
        k_cache[layer, :, position] = k_new.to(k_cache.dtype)
        v_cache[layer, :, position] = v_new.to(v_cache.dtype)
        scales = ()
    else:
        quant = quantize_rows_int4 if kind == "int4" else quantize_rows
        k_cache[layer, :, position], k_scale[layer, :, position] = quant(k_new)
        v_cache[layer, :, position], v_scale[layer, :, position] = quant(v_new)
        scales = (k_scale[layer], v_scale[layer])
    return _attend_plain(q, k_cache[layer], v_cache[layer], key_mask, position,
                         n_head, kind, *scales)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KIND_CODE = {"fp": 0, "int8": 1, "int4": 2}
# csrc/decode_attention.cu: a block owns a few heads of a batch row and a
# chunk of _CHUNK slots (one chunk up to position 255: the default 220-token
# call)
_CHUNK = 256
_counters = {}  # (device, stream) -> int32 zeros the kernel leaves zero


def int4_pairs(n_head: int, head_dim: int) -> bool:
    """Whether the int4 kernel attends the head pair (h, h + H/2) that shares
    its bytes together: even H and 16-byte head slices."""
    return n_head % 2 == 0 and head_dim % 16 == 0


def split_slots(position: int):
    """(chunks, slots a chunk) over the live slots ``0..position``: chunks of
    ``_CHUNK`` slots, the last one holding ``position``, a block each. A
    function of the position alone, never of the batch: the chunks' partial
    sums merge in chunk order, so the summation tree of a row's context is
    the same at any batch size."""
    live = position + 1
    return -(-live // _CHUNK), _CHUNK


def _zeroed_counters(device, n: int) -> torch.Tensor:
    # the blocks of a split call count themselves here and the last resets
    # its count, so the buffer stays zero between calls on one stream
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _launch(kind: str, q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
            key_mask, position: int, layer: int, n_head: int) -> torch.Tensor:
    """Validate and launch ``mmtg_decode_attention``. ``k_new is None`` turns
    the append stage off; ``v_cache is None`` is the merged k‖v layout."""
    append, merged = k_new is not None, v_cache is None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode attention: q dtype {q.dtype} not f32/bf16")
    if q.dim() != 2 or k_cache.dim() != 4:
        raise ValueError("decode attention: q must be [B, D] and the cache "
                         "[L, B, T, row]")
    B, D = q.shape
    L, _, T, row = k_cache.shape
    if merged and (kind != "int8" or not append):
        raise ValueError("decode attention: the merged k||v cache is int8 "
                         "with the append stage only")
    if kind == "int4" and D % 2:
        raise ValueError(f"decode attention: int4 needs an even D, got {D}")
    want_row = {"fp": D, "int8": 2 * D if merged else D, "int4": D // 2}[kind]
    if k_cache.shape != (L, B, T, want_row) or key_mask.shape != (B, T):
        raise ValueError(
            f"decode attention: {kind} cache {tuple(k_cache.shape)} / key_mask "
            f"{tuple(key_mask.shape)} do not fit q {tuple(q.shape)}")
    if not merged and v_cache.shape != k_cache.shape:
        raise ValueError("decode attention: k / v cache shapes differ")
    if append and (k_new.shape != (B, D) or v_new.shape != (B, D)
                   or k_new.dtype != q.dtype or v_new.dtype != q.dtype):
        raise ValueError("decode attention: k_new / v_new must be [B, D] of "
                         "q's dtype")
    if key_mask.dtype != torch.int32:
        raise TypeError("decode attention: key_mask must be int32")
    caches = [k_cache] if merged else [k_cache, v_cache]
    if kind == "fp":
        if any(c.dtype != q.dtype for c in caches):
            raise TypeError("decode attention: fp cache dtype must equal q's")
    else:
        if any(c.dtype != torch.int8 for c in caches):
            raise TypeError(f"decode attention: {kind} cache must be int8")
        if (k_scale.shape != (L, B, T) or v_scale.shape != (L, B, T)
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise TypeError("decode attention: scales must be [L, B, T] f32")
    if D % n_head or D // n_head > 128 or n_head > 32:
        raise ValueError(f"decode attention: D={D}, n_head={n_head} "
                         "(needs head_dim <= 128 and n_head <= 32)")
    hd = D // n_head
    pair = kind == "int4" and int4_pairs(n_head, hd)
    # a lane reads 16 bytes of a head's row (the odd-H int4 path reads bytes)
    head_bytes = {"fp": hd * q.element_size(), "int8": hd, "int4": hd if pair else 16}[kind]
    if head_bytes % 16:
        raise ValueError(f"decode attention: a {kind} head of {hd} lanes is "
                         f"{head_bytes} bytes, not a multiple of 16")
    if not (0 <= position < T and 0 <= layer < L):
        raise IndexError(f"decode attention: position {position} / layer "
                         f"{layer} outside cache [L={L}, T={T}]")
    tensors = [q, key_mask] + caches
    if append:
        tensors += [k_new, v_new]
    if kind != "fp":
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode attention: all tensors must be "
                             "contiguous and on one CUDA device")
    if any(c.data_ptr() % 16 for c in caches):
        raise ValueError("decode attention: cache storage must start on a "
                         "16-byte boundary")
    ctx = torch.empty_like(q)
    n_split, chunk = split_slots(position)
    scratch = counters = None
    if n_split > 1:
        scratch = torch.empty(B * n_head * n_split * (hd + 2), dtype=torch.float32,
                              device=q.device)
        counters = _zeroed_counters(q.device, B * n_head)
    lib = _build.load()
    # the merged buffer's v half starts D int8 elements into each row
    v_ptr = k_cache.data_ptr() + D if merged else v_cache.data_ptr()
    with torch.cuda.device(q.device):
        err = lib.mmtg_decode_attention(
            q.data_ptr(),
            k_new.data_ptr() if append else None,
            v_new.data_ptr() if append else None,
            k_cache.data_ptr(), v_ptr,
            k_scale.data_ptr() if kind != "fp" else None,
            v_scale.data_ptr() if kind != "fp" else None,
            key_mask.data_ptr(), ctx.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            counters.data_ptr() if counters is not None else None,
            B, T, D, n_head, position, layer,
            1.0 / math.sqrt(hd), _KIND_CODE[kind], int(append), row,
            _DTYPE_CODE[q.dtype], n_split, chunk, int(pair),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "mmtg_decode_attention")
    return ctx


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    return False


def decode_attention_int8_append(q, k_new, v_new, k_cache, v_cache, k_scale,
                                 v_scale, key_mask, position: int, layer: int,
                                 n_head: int = 12) -> torch.Tensor:
    """Quantize-append + int8-cache decode attention. ``q``/``k_new``/
    ``v_new`` ``[B, D]``; caches ``[L, B, T, D]`` int8 and scales
    ``[L, B, T]`` f32, updated in place; ``key_mask`` ``[B, T]`` int32.
    Returns ctx ``[B, D]`` in q's dtype."""
    if _on_cpu(q):
        return decode_attention_append_plain(
            q, k_new, v_new, k_cache, v_cache, key_mask, position, layer,
            n_head, k_scale, v_scale)
    ctx = _launch("int8", q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                  key_mask, position, layer, n_head)
    decode_attention_int8_append.launches += 1
    return ctx


def decode_attention_fp_append(q, k_new, v_new, k_cache, v_cache, key_mask,
                               position: int, layer: int,
                               n_head: int = 12) -> torch.Tensor:
    """Append + full-precision-cache decode attention (the cache dtype
    equals q's). Caches updated in place; returns ctx ``[B, D]``."""
    if _on_cpu(q):
        return decode_attention_append_plain(
            q, k_new, v_new, k_cache, v_cache, key_mask, position, layer,
            n_head)
    ctx = _launch("fp", q, k_new, v_new, k_cache, v_cache, None, None,
                  key_mask, position, layer, n_head)
    decode_attention_fp_append.launches += 1
    return ctx


def decode_attention_int4_append(q, k_new, v_new, k_cache, v_cache, k_scale,
                                 v_scale, key_mask, position: int, layer: int,
                                 n_head: int = 12) -> torch.Tensor:
    """Quantize-pack-append + int4-cache decode attention: caches
    ``[L, B, T, D/2]`` int8 holding two codes a byte
    (:func:`quantize_rows_int4`), scales ``[L, B, T]`` f32, updated in
    place. Returns ctx ``[B, D]``."""
    if _on_cpu(q):
        return decode_attention_append_plain(
            q, k_new, v_new, k_cache, v_cache, key_mask, position, layer,
            n_head, k_scale, v_scale)
    ctx = _launch("int4", q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                  key_mask, position, layer, n_head)
    decode_attention_int4_append.launches += 1
    return ctx


def decode_attention_int8_append_merged(q, k_new, v_new, kv_cache, k_scale,
                                        v_scale, key_mask, position: int,
                                        layer: int,
                                        n_head: int = 12) -> torch.Tensor:
    """:func:`decode_attention_int8_append` with k and v in one
    ``[L, B, T, 2D]`` int8 buffer, k in the low lane half. The buffer and
    both scales are updated in place; returns ctx ``[B, D]``. Bit-identical
    to the split layout."""
    if _on_cpu(q):
        return decode_attention_append_plain(
            q, k_new, v_new, kv_cache, None, key_mask, position, layer,
            n_head, k_scale, v_scale)
    ctx = _launch("int8", q, k_new, v_new, kv_cache, None, k_scale, v_scale,
                  key_mask, position, layer, n_head)
    decode_attention_int8_append_merged.launches += 1
    return ctx


def decode_attention(q, k_cache, v_cache, key_mask, position: int, layer: int,
                     n_head: int = 12) -> torch.Tensor:
    """Read-only attention of one query over layer ``layer``'s live prefix
    of a full-precision cache; returns ctx ``[B, D]``."""
    if _on_cpu(q):
        return decode_attention_plain(q, k_cache, v_cache, key_mask, position,
                                      layer, n_head)
    ctx = _launch("fp", q, None, None, k_cache, v_cache, None, None, key_mask,
                  position, layer, n_head)
    decode_attention.launches += 1
    return ctx


def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, key_mask,
                          position: int, layer: int,
                          n_head: int = 12) -> torch.Tensor:
    """Read-only int8-cache decode attention (see :func:`decode_attention`)."""
    if _on_cpu(q):
        return decode_attention_plain(q, k_cache, v_cache, key_mask, position,
                                      layer, n_head, k_scale, v_scale)
    ctx = _launch("int8", q, None, None, k_cache, v_cache, k_scale, v_scale,
                  key_mask, position, layer, n_head)
    decode_attention_int8.launches += 1
    return ctx


def decode_attention_int4(q, k_cache, v_cache, k_scale, v_scale, key_mask,
                          position: int, layer: int,
                          n_head: int = 12) -> torch.Tensor:
    """Read-only int4-cache decode attention: caches ``[L, B, T, D/2]``."""
    if _on_cpu(q):
        return decode_attention_plain(q, k_cache, v_cache, key_mask, position,
                                      layer, n_head, k_scale, v_scale)
    ctx = _launch("int4", q, None, None, k_cache, v_cache, k_scale, v_scale,
                  key_mask, position, layer, n_head)
    decode_attention_int4.launches += 1
    return ctx


WRAPPERS = (decode_attention_int8_append, decode_attention_fp_append,
            decode_attention_int4_append, decode_attention_int8_append_merged,
            decode_attention, decode_attention_int8, decode_attention_int4)
for _fn in WRAPPERS:
    _fn.launches = 0
