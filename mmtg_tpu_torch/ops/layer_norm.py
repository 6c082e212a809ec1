"""Batch-invariant LayerNorm over the last axis, with the port's numerics
(f32 statistics, elementwise steps in the input's type).

On the card PyTorch's reduction kernel sets how many threads share a row,
and the order they sum in, by the number of rows, so a row's mean (and,
after its rounding, the row) changed with the batch. For CUDA tensors
:func:`layer_norm_rows` launches the hand-written kernel
``csrc/layer_norm.cu`` (a warp a row, an order set by the row's width
alone), for CPU tensors it runs the plain version, :func:`layer_norm_plain`
(the JAX package's numerics, which the train path also runs: the kernel has
no gradient). The wrapper counts its launches in ``layer_norm_rows.launches``.
"""

from __future__ import annotations

import torch

from mmtg_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x, g, b, eps):
    """The JAX package's LayerNorm numerics: row statistics accumulate in
    f32, elementwise math stays in x's dtype."""
    mean = x.float().mean(dim=-1, keepdim=True)
    xm = x - mean.to(x.dtype)
    var = xm.square().float().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps).to(x.dtype)
    return xm * rstd * g + b


def layer_norm_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm of ``x [..., D]`` with gain ``g`` and bias ``b`` ``[D]``,
    in x's type."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, g, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_rows: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"layer_norm_rows: x {x.dtype}, g {g.dtype}, b {b.dtype}: "
                        "one type, f32 or bf16")
    D = x.shape[-1]
    if g.shape != (D,) or b.shape != (D,):
        raise ValueError(f"layer_norm_rows: g {tuple(g.shape)}, b {tuple(b.shape)} "
                         f"for rows of {D}")
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad
                                    or b.requires_grad):
        raise RuntimeError("layer_norm_rows: the kernel has no gradient")
    if g.device != x.device or b.device != x.device:
        raise ValueError("layer_norm_rows: all tensors must be on one CUDA device")
    x, g, b = x.contiguous(), g.contiguous(), b.contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mmtg_layer_norm(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), x.numel() // D, D, float(eps),
                                  _DTYPE_CODE[x.dtype],
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mmtg_layer_norm")
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0
