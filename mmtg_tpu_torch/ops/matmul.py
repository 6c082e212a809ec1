"""Batch-invariant dense product: ``x @ w (+ bias)`` whose rows do not depend
on how many rows are computed beside them.

The decode promises that a (request, seed) gives the same tokens whatever
rows share its batch (:mod:`mmtg_tpu_torch.serve`). On the card
``torch.matmul`` calls cuBLAS, which picks its kernel, tile and split of K by
the shape, so a row's bits change with M. For CUDA tensors :func:`matmul`
launches the hand-written kernel ``csrc/matmul.cu`` (one tile shape and one
K order for every M, no split of K; bf16 on the tensor cores with f32 sums,
f32 on CUDA cores), for CPU tensors it runs the plain version,
:func:`matmul_plain`. It has no gradient: the train path keeps
``torch.matmul``. The wrapper counts its launches in ``matmul.launches``.
"""

from __future__ import annotations

import torch

from mmtg_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def matmul_plain(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ w (+ bias)``: the product rounded to x's type, then the sum with
    the bias rounded once more."""
    y = x @ w
    return y if bias is None else y + bias


def _weight_layout(w: torch.Tensor, vec: int):
    """(the weight as the kernel reads it, trans): ``[.., K, N]`` with rows of
    N values, or ``[.., N, K]`` with rows of K values (``trans``; the
    transpose of a contiguous ``[N, K]`` as ``wte.T`` is read in place). A
    row is read 16 bytes (``vec`` values) at a time."""
    wt = w.transpose(-1, -2)
    if w.is_contiguous() and w.shape[-1] % vec == 0:
        return w, False
    if wt.is_contiguous():
        return wt, True
    return wt.contiguous(), True


def _launch(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul: dtype {x.dtype} not f32/bf16")
    if w.dtype != x.dtype or (bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"matmul: x {x.dtype}, w {w.dtype}"
                        f"{'' if bias is None else f', bias {bias.dtype}'}: one type")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        raise RuntimeError("matmul: the kernel has no gradient (the train path "
                           "uses torch.matmul)")
    batched = w.dim() == 3
    if w.dim() not in (2, 3) or x.shape[-1] != w.shape[-2] or (
            batched and (x.dim() != 3 or x.shape[0] != w.shape[0])):
        raise ValueError(f"matmul: x {tuple(x.shape)} @ w {tuple(w.shape)} (w [K, N], "
                         "or x [Z, M, K] @ w [Z, K, N])")
    K, N = w.shape[-2:]
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} for N={N}")
    for t in (w,) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError("matmul: all tensors must be on one CUDA device")
    lead = x.shape[:-1]
    vec = 16 // x.element_size()
    if K % vec:  # zeros fill K to whole 16-byte pieces: they add nothing to a sum
        pad = vec - K % vec
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        K += pad
    x = x.contiguous()
    wk, trans = _weight_layout(w, vec)
    if x.data_ptr() % 16:  # a slice of a row (q of the fused QKV)
        x = x.clone()
    if wk.data_ptr() % 16:
        wk = wk.clone()
    out = torch.empty(*lead, N, dtype=x.dtype, device=x.device)
    Z = x.shape[0] if batched else 1
    M = x.numel() // (Z * K)
    b = None if bias is None else bias.contiguous()
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mmtg_matmul(
            x.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), Z, M, N, K, M * K, K * N, M * N, int(trans),
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mmtg_matmul")
    return out


def matmul(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N] (+ bias [N])`` → ``[..., N]`` in x's type, or
    batched (the attention's per-head products): ``x [Z, M, K] @ w [Z, K,
    N]``. ``w`` may be a transposed view (the tied LM head's ``wte.T``, the
    keys ``k.transpose(-1, -2)``): it is read in place where it is the
    transpose of a contiguous matrix."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {x.device}")
    out = _launch(x, w, bias)
    matmul.launches += 1
    return out


matmul.launches = 0


def batched_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., M, K] @ b [..., K, N]`` over the leading axes (the
    attention's heads) through :func:`matmul`'s batch axis; ``torch.matmul``
    for CPU tensors."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    lead = a.shape[:-2]
    out = matmul(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    return out.view(*lead, *out.shape[-2:])
