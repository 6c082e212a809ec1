"""Fused append + single-query decode attention over the KV cache.

PyTorch counterpart of :mod:`mmtg_tpu.ops.decode_attention`
(``decode_attention_int8_append`` / ``decode_attention_fp_append``, one
Pallas builder in ``decode_attention_unified.py``). Each wrapper writes the
step's k/v row into slot ``position`` of layer ``layer`` of the
``[L, B, T, D]`` cache IN PLACE (the TPU version aliases its cache buffers
the same way) and returns the attention context ``[B, D]`` over the live
prefix: slots ``t <= position`` with ``key_mask[b, t] != 0``.

For CUDA tensors the wrappers launch the hand-written kernel
``csrc/decode_attention.cu``; for CPU tensors they run
:func:`decode_attention_append_plain`, the same math in plain PyTorch. Each
wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from mmtg_tpu_torch.kernels import _build

NEG_INF = -1e30


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis
    (``mmtg_tpu.models.gpt2.quantize_rows``): ``scale = max(max|x|, 1e-6) /
    127``, ``q = clip(round_half_even(x / scale), -127, 127)``.

    Returns (values int8 ``[...]``, scales f32 ``[...-1 dims]``)."""
    xf = x.float()
    scale = true_div(xf.abs().amax(dim=-1).clamp_min(1e-6), 127.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division. (PyTorch's CUDA kernel turns
    a division by a Python scalar into a multiply by its reciprocal, which
    can differ in the last bit from JAX and from the CUDA kernel.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def decode_attention_append_plain(q, k_new, v_new, k_cache, v_cache, key_mask,
                                  position: int, layer: int, n_head: int,
                                  k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device). With ``k_scale`` /
    ``v_scale`` the cache is int8 and the row is quantized first; otherwise
    the row is stored in the cache's dtype. Caches are updated in place."""
    B, D = q.shape
    hd = D // n_head
    quant = k_scale is not None
    if quant:
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        k_cache[layer, :, position] = kq
        v_cache[layer, :, position] = vq
        k_scale[layer, :, position] = ks
        v_scale[layer, :, position] = vs
    else:
        k_cache[layer, :, position] = k_new.to(k_cache.dtype)
        v_cache[layer, :, position] = v_new.to(v_cache.dtype)
    W = position + 1  # slots past `position` are never read
    # q pre-scaled and rounded back to its dtype, as the TPU wrapper does
    qs = (q * (1.0 / math.sqrt(hd))).to(q.dtype).float().view(B, n_head, hd)
    k = k_cache[layer, :, :W].float().view(B, W, n_head, hd)
    s = torch.einsum("bhd,bthd->bht", qs, k)
    if quant:
        s = s * k_scale[layer, :, :W][:, None, :]
    s = s + ((1.0 - key_mask[:, :W].float()) * NEG_INF)[:, None, :]
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * v_scale[layer, :, :W][:, None, :]
    v = v_cache[layer, :, :W].float().view(B, W, n_head, hd)
    return torch.einsum("bht,bthd->bhd", p, v).reshape(B, D).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, key_mask,
            position: int, layer: int, n_head: int) -> torch.Tensor:
    """Validate and launch ``mmtg_decode_attention_append``."""
    int8 = k_scale is not None
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode attention: q dtype {q.dtype} not f32/bf16")
    L, B, T, D = k_cache.shape
    if q.shape != (B, D) or k_new.shape != (B, D) or v_new.shape != (B, D):
        raise ValueError("decode attention: q/k_new/v_new must be [B, D] "
                         f"with cache {tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape or key_mask.shape != (B, T):
        raise ValueError("decode attention: cache / key_mask shape mismatch")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("decode attention: q, k_new, v_new dtypes differ")
    if key_mask.dtype != torch.int32:
        raise TypeError("decode attention: key_mask must be int32")
    if int8:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError("decode attention: int8 cache expected")
        if (k_scale.shape != (L, B, T) or v_scale.shape != (L, B, T)
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise TypeError("decode attention: scales must be [L, B, T] f32")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode attention: fp cache dtype must equal q's")
    if D % n_head or D // n_head > 128 or n_head > 32:
        raise ValueError(f"decode attention: D={D}, n_head={n_head} "
                         "(needs head_dim <= 128 and n_head <= 32)")
    if not (0 <= position < T and 0 <= layer < L):
        raise IndexError(f"decode attention: position {position} / layer "
                         f"{layer} outside cache [L={L}, T={T}]")
    tensors = [q, k_new, v_new, k_cache, v_cache, key_mask]
    if int8:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode attention: all tensors must be "
                             "contiguous and on one CUDA device")
    ctx = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.mmtg_decode_attention_append(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            key_mask.data_ptr(), ctx.data_ptr(),
            B, T, D, n_head, position, layer,
            1.0 / math.sqrt(D // n_head), int(int8), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "mmtg_decode_attention_append")
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
    ctx = _launch(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
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
    ctx = _launch(q, k_new, v_new, k_cache, v_cache, None, None, key_mask,
                  position, layer, n_head)
    decode_attention_fp_append.launches += 1
    return ctx


decode_attention_int8_append.launches = 0
decode_attention_fp_append.launches = 0
