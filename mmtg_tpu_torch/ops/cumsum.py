"""Batch-invariant prefix sum along the last axis (the sampler's nucleus
filter: the cumulative probability of the sorted candidates).

On the card ``torch.cumsum`` lays a row's scan out by the number of rows, so
one row's sums, and with them where its nucleus ends, changed with the batch
size. For CUDA tensors :func:`row_cumsum` launches the hand-written kernel
``csrc/row_cumsum.cu`` (f32 sums rounded once an entry to the input's type,
in an order set by the row's length V alone), for CPU tensors it runs the
plain version, :func:`row_cumsum_plain`. The launch picks the kernel's form
by V alone (:func:`path` states the rule): a thread a row for short rows
(the sampler's top-k 10; the plain version's sums, bit for bit), a block a
row with a scan of fixed shape for long ones (top-p over the vocabulary). The wrapper counts its launches in
``row_cumsum.launches``.
"""

from __future__ import annotations

import torch

from mmtg_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SHORT_V = 32  # csrc/row_cumsum.cu kShortV: rows up to this long take a thread each


def path(V: int) -> str:
    """The form the kernel takes for rows of ``V`` values (the launch
    applies this rule itself): ``"short"`` (a thread a row, summed in order)
    up to :data:`SHORT_V`, else ``"long"`` (a block a row). A function of V
    alone: never of the number of rows."""
    return "short" if V <= SHORT_V else "long"


def row_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The prefix sums accumulated in f32, each rounded once to x's type
    (``torch.cumsum`` of a bf16 tensor on the card rounds its partial sums
    too)."""
    return torch.cumsum(x, dim=-1, dtype=torch.float32).to(x.dtype)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of ``x [..., V]`` along its last axis, in x's
    type."""
    if x.device.type == "cpu":
        return row_cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_cumsum: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_cumsum: dtype {x.dtype} not f32/bf16")
    x = x.contiguous()
    out = torch.empty_like(x)
    V = x.shape[-1] if x.dim() else 1
    R = x.numel() // V if V else 0
    if R == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mmtg_row_cumsum(x.data_ptr(), out.data_ptr(), R, V,
                                  _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mmtg_row_cumsum")
    row_cumsum.launches += 1
    return out


row_cumsum.launches = 0
