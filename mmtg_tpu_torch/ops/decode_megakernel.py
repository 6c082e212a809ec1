"""Whole-step decode kernel: all transformer layers of one decode step in one
launch.

PyTorch counterpart of :mod:`mmtg_tpu.ops.decode_megakernel`
(``decode_block_fused``). Per layer: LN1 → QKV product + bias → q scaled →
int8 quantize-append of the k/v rows → attention over the live cache prefix →
output projection + residual → LN2 → MLP with ``gelu_new`` → residual.
Returns the hidden state ``[B, D]`` BEFORE the final LayerNorm; the int8
caches and their scales are updated IN PLACE.

For CUDA tensors :func:`decode_block_fused` launches the hand-written kernel
``csrc/decode_block_fused.cu``, which computes the four products of a layer
in its own body; for CPU tensors it runs :func:`decode_block_fused_plain`,
the per-layer loop in plain PyTorch with the same rounding points. The
wrapper counts its launches in ``.launches``.

Scope, as in the JAX package: int8 split cache, full-precision weights of
the stream dtype. The kernel's own limits: D a multiple of 8 (16-byte weight
loads), ``head_dim <= 128``, and a shared-memory budget that holds a block's
one batch row (about D <= 5000). The TPU kernel's ``D % 128`` and
batch-multiple-of-8 limits are Mosaic's and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mmtg_tpu_torch.kernels import _build
from mmtg_tpu_torch.ops.decode_attention import decode_attention_append_plain

# the order of the C entry point's `params` array
PARAM_KEYS = ("ln1_g", "ln1_b", "attn_w", "attn_b", "attn_proj_w", "attn_proj_b",
              "ln2_g", "ln2_b", "mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 384  # csrc/decode_block_fused.cu kThreads
_SMEM_LIMIT = 232448  # bytes of shared memory one block can use on Hopper


def decode_block_fused_plain(h_embed, params_h: Dict, k_cache, v_cache, k_scale,
                             v_scale, key_mask, position: int, n_head: int = 12,
                             eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): the per-layer loop
    with the plain append + attention, rounding to the stream dtype where
    the kernel does (after every product and every elementwise op)."""
    # imported here: the model module imports this one
    from mmtg_tpu_torch.models.gpt2 import gelu_new, layer_norm

    p, h = params_h, h_embed
    D = h.shape[-1]
    for l in range(p["attn_w"].shape[0]):
        a = layer_norm(h, p["ln1_g"][l], p["ln1_b"][l], eps)
        q, k, v = (a @ p["attn_w"][l] + p["attn_b"][l]).split(D, dim=-1)
        ctx = decode_attention_append_plain(
            q, k, v, k_cache, v_cache, key_mask, position, l, n_head,
            k_scale, v_scale)
        h = h + ctx @ p["attn_proj_w"][l] + p["attn_proj_b"][l]
        m = layer_norm(h, p["ln2_g"][l], p["ln2_b"][l], eps)
        m = gelu_new(m @ p["mlp_fc_w"][l] + p["mlp_fc_b"][l])
        h = h + m @ p["mlp_proj_w"][l] + p["mlp_proj_b"][l]
    return h


def _launch(h_embed, params_h, k_cache, v_cache, k_scale, v_scale, key_mask,
            position: int, n_head: int, eps: float) -> torch.Tensor:
    """Validate and launch ``mmtg_decode_block_fused``."""
    dt = h_embed.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"decode_block_fused: dtype {dt} not f32/bf16")
    if h_embed.dim() != 2 or k_cache.dim() != 4:
        raise ValueError("decode_block_fused: h_embed must be [B, D] and the "
                         "caches [L, B, T, D]")
    B, D = h_embed.shape
    L, _, T, _ = k_cache.shape
    if k_cache.shape != (L, B, T, D) or v_cache.shape != (L, B, T, D):
        raise ValueError(
            f"decode_block_fused: caches {tuple(k_cache.shape)} / "
            f"{tuple(v_cache.shape)} are not the split int8 [L, B, T, D={D}] "
            "layout (the int4 and merged caches take the per-layer kernels)")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError("decode_block_fused: int8 caches expected")
    if (k_scale.shape != (L, B, T) or v_scale.shape != (L, B, T)
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("decode_block_fused: scales must be [L, B, T] f32")
    if key_mask.shape != (B, T) or key_mask.dtype != torch.int32:
        raise TypeError("decode_block_fused: key_mask must be [B, T] int32")
    if D % 8 or D % n_head or D // n_head > 128:
        raise ValueError(f"decode_block_fused: D={D}, n_head={n_head} (needs "
                         "D % 8 == 0 and head_dim <= 128)")
    if not 0 <= position < T:
        raise IndexError(f"decode_block_fused: position {position} outside "
                         f"the cache's {T} slots")
    shapes = {"attn_w": (L, D, 3 * D), "attn_b": (L, 3 * D),
              "attn_proj_w": (L, D, D), "mlp_fc_w": (L, D, 4 * D),
              "mlp_fc_b": (L, 4 * D), "mlp_proj_w": (L, 4 * D, D)}
    for key in PARAM_KEYS:
        w = params_h[key]
        if w.shape != shapes.get(key, (L, D)) or w.dtype != dt:
            raise TypeError(
                f"decode_block_fused: params_h[{key!r}] is {tuple(w.shape)} "
                f"{w.dtype}; full-precision weights of the stream dtype {dt} "
                "are needed (weight-only int8 takes the per-layer kernels)")
    tensors = [h_embed, k_cache, v_cache, k_scale, v_scale, key_mask]
    tensors += [params_h[k] for k in PARAM_KEYS]
    for t in tensors:
        if t.device != h_embed.device or not t.is_contiguous():
            raise ValueError("decode_block_fused: all tensors must be "
                             "contiguous and on one CUDA device")
    vec = 16 // h_embed.element_size()
    if 4 * (9 * D + max(_THREADS * vec, 4 * D)) > _SMEM_LIMIT:
        raise ValueError(f"decode_block_fused: D={D} does not fit a block's "
                         "shared memory")
    out = torch.empty_like(h_embed)
    lib = _build.load()
    ptrs = (ctypes.c_void_p * len(PARAM_KEYS))(
        *[params_h[k].data_ptr() for k in PARAM_KEYS])
    with torch.cuda.device(h_embed.device):
        err = lib.mmtg_decode_block_fused(
            h_embed.data_ptr(), ptrs, k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), L, B, T, D, n_head, position, eps,
            1.0 / math.sqrt(D // n_head), _DTYPE_CODE[dt],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mmtg_decode_block_fused")
    return out


def decode_block_fused(h_embed, params_h: Dict, k_cache, v_cache, k_scale,
                       v_scale, key_mask, position: int, n_head: int = 12,
                       eps: float = 1e-5) -> torch.Tensor:
    """Run ALL transformer layers of one decode step.

    ``h_embed`` ``[B, D]``: the step's token embedding (+ position + type);
    ``params_h``: the stacked layer parameters (``params["h"]``, full
    precision, h's dtype); caches ``[L, B, T, D]`` int8 and scales
    ``[L, B, T]`` f32, updated in place; ``key_mask`` ``[B, T]`` int32.
    Returns h ``[B, D]`` before the final LayerNorm."""
    if h_embed.device.type == "cpu":
        return decode_block_fused_plain(h_embed, params_h, k_cache, v_cache,
                                        k_scale, v_scale, key_mask, position,
                                        n_head, eps)
    if h_embed.device.type != "cuda":
        raise ValueError(f"decode_block_fused: unsupported device {h_embed.device}")
    out = _launch(h_embed, params_h, k_cache, v_cache, k_scale, v_scale,
                  key_mask, position, n_head, eps)
    decode_block_fused.launches += 1
    return out


decode_block_fused.launches = 0
