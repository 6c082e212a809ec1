"""Fused causal self-attention for the train step, forward and backward.

PyTorch counterpart of :func:`mmtg_tpu.ops.train_attention.mha_train_packed`:
causal multi-head attention over the standard GPT-2 ``c_attn`` slab
``qkv [B, T, 3·H·hd]`` (q all heads | k all heads | v all heads), with the
projection bias added inside, an additive ``[B, T]`` key bias, an f32
softmax, seeded attention dropout, and a gradient that recomputes the
probabilities and the same dropout bits and returns ``dqkv`` in the slab's
layout plus the projection-bias gradient. The ``[B, H, T, T]`` probabilities
never reach device memory.

:func:`mha_train_packed` is a ``torch.autograd.Function``: for CUDA tensors
its forward and its backward launch the hand-written kernels of
``csrc/train_attention.cu`` (and raise if they cannot); for CPU tensors it
runs :func:`mha_train_packed_plain`, the same math in plain differentiable
PyTorch. ``mha_train_packed.fwd_launches`` / ``.bwd_launches`` count the
kernel launches.

Dropout bits. The TPU kernel draws from the core's own generator, whose bits
depend on its launch grid. Here ``keep(b, h, i, j)`` is a pure function of
the element's coordinates::

    fmix32(x): x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13;
               x *= 0xC2B2AE35; x ^= x >> 16          (murmur3 finaliser)
    row  = (b·H + h)·T + i
    rkey = fmix32(row ^ fmix32(seed + 0x9E3779B9))
    keep = fmix32(rkey + j·0x9E3779B9) >= thr
    thr  = min(round(rate·2³²), 2³² − 1)

all in uint32 arithmetic. :func:`dropout_keep_mask` computes it with torch
integer ops and the kernels compute it inline, so forward, backward, a
recomputed forward and the plain version see identical masks.
"""

from __future__ import annotations

import torch

from mmtg_tpu_torch.kernels import _build

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def dropout_threshold(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def dropout_keep_mask(seed: torch.Tensor, B: int, H: int, T: int,
                      rate: float) -> torch.Tensor:
    """The attention-dropout keep mask ``[B, H, T, T]`` (bool) for ``seed``
    (an int32 tensor with one element): the module docstring's hash."""
    dev = seed.device
    s = (seed.reshape(-1)[0].to(torch.int64) + _GOLDEN) & _M32
    rows = torch.arange(B * H * T, dtype=torch.int64, device=dev)
    rkey = _fmix32(rows ^ _fmix32(s))
    cols = (torch.arange(T, dtype=torch.int64, device=dev) * _GOLDEN) & _M32
    bits = _fmix32((rkey[:, None] + cols[None, :]) & _M32)
    return (bits >= dropout_threshold(rate)).view(B, H, T, T)


def _inv_keep(rate: float) -> float:
    """``1 / (1 - rate)`` as the f32 value both versions multiply by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def mha_train_packed_plain(qkv, qkv_bias, bias, seed, n_head: int,
                           dropout_rate: float = 0.0, scale: float = 1.0):
    """Plain differentiable PyTorch version (any device): f32 scores and
    softmax, products on values of the slab's dtype with f32 accumulation.
    ``qkv`` ``[B, T, 3·H·hd]``, ``qkv_bias`` ``[3·H·hd]``, ``bias`` ``[B, T]``
    f32 additive key bias, ``seed`` int32 ``[1]``. Returns ctx ``[B, T,
    H·hd]`` in the slab's dtype."""
    B, T, S = qkv.shape
    hd = S // (3 * n_head)
    dt = qkv.dtype
    q, k, v = ((qkv + qkv_bias).view(B, T, 3, n_head, hd).permute(2, 0, 3, 1, 4)
               .float())  # each [B, H, T, hd], slab-dtype values held in f32
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    i = torch.arange(T, device=qkv.device)
    s = s + torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).to(s.dtype)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, B, n_head, T, dropout_rate)
        p = torch.where(keep, p * _inv_keep(dropout_rate), torch.zeros_like(p))
    ctx = torch.matmul(p.to(dt).float(), v)
    return ctx.transpose(1, 2).reshape(B, T, n_head * hd).to(dt)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(qkv, qkv_bias, bias, seed, n_head):
    """Raise on what the kernels do not take; returns (B, T, hd)."""
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"mha_train_packed: qkv dtype {qkv.dtype} not f32/bf16")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * n_head):
        raise ValueError(f"mha_train_packed: qkv {tuple(qkv.shape)} is not "
                         f"[B, T, 3*{n_head}*hd]")
    B, T, S = qkv.shape
    hd = S // (3 * n_head)
    if hd > 128 or hd % 8:
        raise ValueError(f"mha_train_packed: head_dim {hd} (needs a multiple "
                         "of 8, at most 128)")
    if T % 128 or T > 512:
        raise ValueError(f"mha_train_packed: T={T} (the caller pads to a "
                         "multiple of 128, at most 512)")
    if B * n_head * T >= 2 ** 31:
        raise ValueError("mha_train_packed: B*H*T must stay below 2**31")
    if qkv_bias.shape != (S,) or qkv_bias.dtype != qkv.dtype:
        raise TypeError("mha_train_packed: qkv_bias must be [3*H*hd] in "
                        "qkv's dtype")
    if bias.shape != (B, T) or bias.dtype != torch.float32:
        raise TypeError("mha_train_packed: bias must be [B, T] float32")
    if seed.numel() != 1 or seed.dtype != torch.int32:
        raise TypeError("mha_train_packed: seed must be one int32")
    for t in (qkv, qkv_bias, bias, seed):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError("mha_train_packed: all tensors must be "
                             "contiguous and on one CUDA device")
    return B, T, hd


def _dropout_args(rate: float):
    if rate > 0.0:
        return _inv_keep(rate), dropout_threshold(rate), 1
    return 1.0, 0, 0


class _MhaTrainPacked(torch.autograd.Function):
    """The kernel pair under autograd (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, qkv, qkv_bias, bias, seed, n_head, dropout_rate, scale):
        B, T, hd = _check(qkv, qkv_bias, bias, seed, n_head)
        out = torch.empty((B, T, n_head * hd), dtype=qkv.dtype,
                          device=qkv.device)
        lse = torch.empty((B, n_head, T), dtype=torch.float32,
                          device=qkv.device)
        inv_keep, thr, drop = _dropout_args(dropout_rate)
        lib = _build.load()
        with torch.cuda.device(qkv.device):
            err = lib.mmtg_mha_train_packed_fwd(
                qkv.data_ptr(), qkv_bias.data_ptr(), bias.data_ptr(),
                seed.data_ptr(), out.data_ptr(), lse.data_ptr(),
                B, T, n_head, hd, scale, inv_keep, thr, drop,
                _DTYPE_CODE[qkv.dtype],
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "mmtg_mha_train_packed_fwd")
        mha_train_packed.fwd_launches += 1
        ctx.save_for_backward(qkv, qkv_bias, bias, seed, out, lse)
        ctx.cfg = (n_head, dropout_rate, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, qkv_bias, bias, seed, out, lse = ctx.saved_tensors
        n_head, dropout_rate, scale = ctx.cfg
        B, T, S = qkv.shape
        hd = S // (3 * n_head)
        dout = dout.contiguous()
        if dout.dtype != qkv.dtype or dout.device != qkv.device:
            raise TypeError("mha_train_packed: d(ctx) must match qkv's dtype "
                            "and device")
        dqkv = torch.empty_like(qkv)
        dsum = torch.empty_like(lse)
        dqb = torch.zeros(S, dtype=torch.float32, device=qkv.device)
        inv_keep, thr, drop = _dropout_args(dropout_rate)
        lib = _build.load()
        with torch.cuda.device(qkv.device):
            err = lib.mmtg_mha_train_packed_bwd(
                qkv.data_ptr(), qkv_bias.data_ptr(), bias.data_ptr(),
                seed.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), dqkv.data_ptr(),
                dqb.data_ptr(), B, T, n_head, hd, scale, inv_keep, thr, drop,
                _DTYPE_CODE[qkv.dtype],
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "mmtg_mha_train_packed_bwd")
        mha_train_packed.bwd_launches += 1
        # the key bias gets a zero gradient, the seed none (as the JAX VJP)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[2] else None
        return dqkv, dqb.to(qkv_bias.dtype), dbias, None, None, None, None


def mha_train_packed(qkv, qkv_bias, bias, seed, n_head: int,
                     dropout_rate: float = 0.0, scale: float = 1.0):
    """Fused causal multi-head attention over a standard-order qkv slab.

    ``qkv`` ``[B, T, 3·H·hd]`` f32/bf16 (``a @ attn_w``, no bias yet),
    ``qkv_bias`` ``[3·H·hd]`` in the same dtype, ``bias`` ``[B, T]`` f32
    additive key bias (0 live, -1e30 padded), ``seed`` one int32 on qkv's
    device (read only when ``dropout_rate > 0``). T is a multiple of 128.
    Returns ctx ``[B, T, H·hd]``. Differentiable in ``qkv`` and ``qkv_bias``."""
    if qkv.device.type == "cpu":
        return mha_train_packed_plain(qkv, qkv_bias, bias, seed, n_head,
                                      dropout_rate, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_train_packed: unsupported device {qkv.device}")
    return _MhaTrainPacked.apply(qkv, qkv_bias, bias, seed, n_head,
                                 float(dropout_rate), float(scale))


mha_train_packed.fwd_launches = 0
mha_train_packed.bwd_launches = 0
