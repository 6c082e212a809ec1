"""Batch-invariant LayerNorm over the last axis, with the port's numerics
(f32 statistics, elementwise steps in the input's type).

On the card PyTorch's reduction kernel sets how many threads share a row,
and the order they sum in, by the number of rows, so a row's mean (and,
after its rounding, the row) changed with the batch. For CUDA tensors
:func:`layer_norm_rows` launches the hand-written kernel
``csrc/layer_norm.cu`` (a warp a row, an order set by the row's width
alone), for CPU tensors it runs the plain version, :func:`layer_norm_plain`
(the JAX package's numerics, which the train path also runs: the kernel has
no gradient). :func:`add_layer_norm_rows` is the residual form the decode
step runs: the pending ``h + y + bias`` and the LayerNorm of the sum in one
launch (plain version :func:`add_layer_norm_plain`). Both count their
launches in ``layer_norm_rows.launches``: each stands in for one LayerNorm.
"""

from __future__ import annotations

import torch

from mmtg_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the widths the kernel reads in 16-byte vectors (every pointer 16-byte aligned)
_VECTOR_WIDTHS = (768, 512)


def layer_norm_plain(x, g, b, eps):
    """The JAX package's LayerNorm numerics: row statistics accumulate in
    f32, elementwise math stays in x's dtype."""
    mean = x.float().mean(dim=-1, keepdim=True)
    xm = x - mean.to(x.dtype)
    var = xm.square().float().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps).to(x.dtype)
    return xm * rstd * g + b


def add_layer_norm_plain(h, y, bias, g, b, eps):
    """The decode step's eager residual then its LayerNorm:
    ``(h + y + bias, layer_norm_plain(h + y + bias))``."""
    h = h + y + bias
    return h, layer_norm_plain(h, g, b, eps)


def _check(name, rows, vectors):
    """One type (f32 or bf16) for every tensor, ``rows`` of one shape
    ``[..., D]`` and ``vectors`` ``[D]``."""
    x = rows[0]
    dtypes = [t.dtype for t in rows + vectors]
    if x.dtype not in _DTYPE_CODE or any(d != x.dtype for d in dtypes):
        raise TypeError(f"{name}: types {[str(d) for d in dtypes]}: one type, f32 or bf16")
    D = x.shape[-1]
    if any(t.shape != x.shape for t in rows) or any(t.shape != (D,) for t in vectors):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in rows + vectors]}: "
                         f"rows of one shape [..., {D}] and vectors [{D}]")


def _launch(name, rows, vectors, eps):
    """The kernel on CUDA tensors: ``rows`` = (x,) or (h, y), ``vectors`` =
    (g, b) or (bias, g, b) → out, or (h_new, out), contiguous."""
    tensors = rows + vectors
    if rows[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rows[0].device}")
    if any(t.device != rows[0].device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no gradient")
    x = rows[0]
    D = x.shape[-1]
    R = x.numel() // D
    tensors = [t.contiguous() for t in tensors]
    if D in _VECTOR_WIDTHS:  # a view may start off a 16-byte boundary: copy it
        tensors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    # (out,) or (h_new, out), row-major like the copies the kernel reads
    outs = [torch.empty_like(t) for t in tensors[:len(rows)]]
    if R == 0:
        return outs[0] if len(outs) == 1 else tuple(outs)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    with torch.cuda.device(x.device):
        if len(rows) == 1:
            err = lib.mmtg_layer_norm(*ptrs, outs[0].data_ptr(), R, D, float(eps),
                                      _DTYPE_CODE[x.dtype], stream)
        else:
            err = lib.mmtg_add_layer_norm(*ptrs, outs[0].data_ptr(), outs[1].data_ptr(),
                                          R, D, float(eps), _DTYPE_CODE[x.dtype], stream)
    _build.check(err, "mmtg_" + name.removesuffix("_rows"))
    layer_norm_rows.launches += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


def layer_norm_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm of ``x [..., D]`` with gain ``g`` and bias ``b`` ``[D]``,
    in x's type."""
    _check("layer_norm_rows", (x,), (g, b))
    if x.device.type == "cpu":
        return layer_norm_plain(x, g, b, eps)
    return _launch("layer_norm_rows", (x,), (g, b), eps)


def add_layer_norm_rows(h: torch.Tensor, y: torch.Tensor, bias: torch.Tensor,
                        g: torch.Tensor, b: torch.Tensor, eps: float):
    """The residual ``h_new = h + y + bias`` (``h``, ``y`` ``[..., D]``,
    ``bias`` ``[D]``; added left to right, each add rounded to the type, as
    the eager ops do) and ``LayerNorm(h_new)`` with ``g``, ``b`` ``[D]``, in
    one launch → ``(h_new, out)``; ``h_new`` is a new tensor."""
    _check("add_layer_norm_rows", (h, y), (bias, g, b))
    if h.device.type == "cpu":
        return add_layer_norm_plain(h, y, bias, g, b, eps)
    return _launch("add_layer_norm_rows", (h, y), (bias, g, b), eps)


layer_norm_rows.launches = 0
