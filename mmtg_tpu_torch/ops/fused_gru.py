"""Fused single-layer GRU over the 5-step experience sequence.

PyTorch counterpart of :func:`mmtg_tpu.ops.fused_gru.fused_gru`. The input
projection ``x @ W_ih + b_ih`` (one large matmul, which the TPU version left
to XLA) runs the batch-invariant product of :mod:`mmtg_tpu_torch.ops.matmul`
on the card (``torch.matmul`` in the plain version); the recurrence ``h @ W_hh + b_hh`` plus the
gates, with ``h`` kept on chip across all T steps, is the hand-written
kernel ``csrc/fused_gru.cu`` for CUDA tensors (one launch: a thread-block
cluster splits the hidden columns and exchanges ``h`` through distributed
shared memory) and :func:`fused_gru_plain` for CPU tensors. Gate order [r, z, n] with the hidden bias inside the reset
product (torch / :func:`mmtg_tpu_torch.ops.rnn.rnn_forward`); math in f32,
output in x's dtype. ``fused_gru.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from mmtg_tpu_torch.kernels import _build
from mmtg_tpu_torch.ops.matmul import matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/fused_gru.cu: a cluster of H / 32 blocks, one a 32 hidden columns,
# each holding its [H, 96] f32 slice of W_hh; Hopper's largest cluster is 16
_COLS_PER_BLOCK, _MAX_BLOCKS = 32, 16


def _input_projection(x, w_ih, b_ih):
    # one matmul over all T steps, in x's dtype, then f32 (fused_gru.py:83)
    return (x @ w_ih + b_ih).float()


def fused_gru_plain(x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``x`` ``[T, B, in]``, returns
    ``[T, B, H]`` in x's dtype."""
    T, B, _ = x.shape
    H = w_hh.shape[0]
    xp = _input_projection(x, w_ih, b_ih)
    w, b = w_hh.float(), b_hh.float()
    h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    outs = []
    for t in range(T):
        xr, xz, xn = xp[t].split(H, dim=-1)
        hr, hz, hn = (h @ w + b).split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h.to(x.dtype))
    return torch.stack(outs)


def fused_gru(x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """Single-layer GRU forward: ``x`` ``[T, B, in]``, ``w_ih`` ``[in,
    3H]``, ``w_hh`` ``[H, 3H]``, biases ``[3H]``; returns ``[T, B, H]``."""
    if x.device.type == "cpu":
        return fused_gru_plain(x, w_ih, w_hh, b_ih, b_hh)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gru: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_gru: x dtype {x.dtype} not f32/bf16")
    T, B, I = x.shape
    H = w_hh.shape[0]
    if (w_ih.shape != (I, 3 * H) or w_hh.shape != (H, 3 * H)
            or b_ih.shape != (3 * H,) or b_hh.shape != (3 * H,)):
        raise ValueError("fused_gru: weight shapes do not match x / w_hh")
    if H % _COLS_PER_BLOCK or H > _COLS_PER_BLOCK * _MAX_BLOCKS:
        raise ValueError(f"fused_gru: hidden size {H} (the kernel takes a "
                         f"multiple of {_COLS_PER_BLOCK}, at most "
                         f"{_COLS_PER_BLOCK * _MAX_BLOCKS})")
    for t in (w_ih, w_hh, b_ih, b_hh):
        if t.device != x.device:
            raise ValueError("fused_gru: all tensors must be on one device")
    # the input projection through the batch-invariant product (a row's
    # bits do not depend on the batch), in x's dtype, then f32
    xp = matmul(x, w_ih, b_ih).float().contiguous()
    w = w_hh.float().contiguous()
    if w.data_ptr() % 16:  # the kernel reads W_hh 16 bytes a thread
        w = w.clone()
    b = b_hh.float().contiguous()
    out = torch.empty(T, B, H, dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mmtg_fused_gru(
            xp.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            T, B, H, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err == -1:
        raise RuntimeError(f"fused_gru: this card cannot place a cluster of "
                           f"{H // _COLS_PER_BLOCK} blocks with H={H}")
    _build.check(err, "mmtg_fused_gru")
    fused_gru.launches += 1
    return out


fused_gru.launches = 0
