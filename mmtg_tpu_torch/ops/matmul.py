"""Batch-invariant dense product: ``x @ w (+ bias)`` whose rows do not depend
on how many rows are computed beside them.

The decode promises that a (request, seed) gives the same tokens whatever
rows share its batch (:mod:`mmtg_tpu_torch.serve`). On the card
``torch.matmul`` calls cuBLAS, which picks its kernel, tile and split of K by
the shape, so a row's bits change with M. For CUDA tensors :func:`matmul`
launches the hand-written kernel ``csrc/matmul.cu``, for CPU tensors it runs
the plain version, :func:`matmul_plain`. It has no gradient: the train path
keeps ``torch.matmul``. The wrapper counts its launches in
``matmul.launches``.

What the kernel runs is :func:`plan`, a pure function of ``(K, N, dtype,
sm_count)``: never of the rows M nor of the batch Z. bf16 products are cut
into column tiles of 64 or 32 and K into ranges of whole 64-value stages,
enough tiles x ranges to fill the card at any M. Each range's partial sums
are one mma chain; every output adds them left to right in range order,
inside the launch: over the blocks of a thread-block cluster, one a range,
while the tiles are few (the decode), or by one block walking the ranges
when they are many (the prefill, B = 512). Both forms give the same bits;
the launch picks by M. f32 keeps one range on CUDA cores (the parity path).
Products with K of at most ``SMALL_K`` (the attention's per-head ``probs @
v``, the beta mix's K = 3) take the small path: one FMA chain over k in
order per output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from mmtg_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"tiled": 0, "small": 1}

# csrc/matmul.cu: kSmallK, kMaxRanges, kMaxSlots, the stage depth by type
SMALL_K = 32       # K at most on the small path
MAX_RANGES = 16    # K ranges at most: the blocks of one cluster
MAX_SLOTS = 4      # stages in flight at most
TILE_WIDTHS = (64, 32)  # bf16 column tiles, tried in this order
_STAGE = {torch.bfloat16: 64, torch.float32: 32}


class Plan(NamedTuple):
    """How the kernel computes a ``[.., K] @ [K, N]`` product. ``path``:
    ``"tiled"`` or ``"small"``; ``bn``: weight columns a block (the small
    path: a thread's 4); ``bk``: K values a stage; ``ranges``: the K ranges
    ``(k0, k1)``, whole stages in order, each one mma chain (the last ends at
    K), added left to right; ``slots``: stages in flight a block of the
    cluster form."""
    path: str
    bn: int
    bk: int
    ranges: Tuple[Tuple[int, int], ...]
    slots: int

    @property
    def spr(self) -> int:
        """K stages a range (the last range may hold fewer)."""
        k0, k1 = self.ranges[0]
        return -(-(k1 - k0) // self.bk)


@functools.lru_cache(maxsize=None)
def plan(K: int, N: int, dtype: torch.dtype, sm_count: int) -> Plan:
    """The kernel's plan for ``[.., K] @ [K, N]`` in ``dtype`` on a card of
    ``sm_count`` SMs. Pure Python, and no argument names the rows or the
    batch: every output's summation order is a function of these four alone.

    bf16: the first column tile of :data:`TILE_WIDTHS` whose tiles x ranges
    reach ``sm_count`` blocks (else the one with more blocks), with the
    fewest K ranges (at most :data:`MAX_RANGES`, of equal whole stages but
    the last) that get there; a product of ``sm_count`` tiles or more keeps
    one range. The rule is "the fewest ranges that fill the card", not the
    fastest candidate: ``tools/matmul_plans`` times every candidate, and on
    an H100 80GB HBM3 (700 W) the rule's plans cost 1.1-4.0 us more than the
    best one over M = 8, 64 and 512 together (2-10%: ``attn_proj`` 12 ranges
    against 6, ``mlp_proj`` 12 against 8, the projector's 32-column tiles
    against 64), and tie on the LM head."""
    if K <= SMALL_K:
        return Plan("small", 4, K, ((0, K),), 1)
    bk = _STAGE[dtype]
    if dtype == torch.float32:
        return Plan("tiled", 64, bk, ((0, K),), MAX_SLOTS)
    nk = -(-K // bk)
    best = None
    for bn in TILE_WIDTHS:
        tiles = -(-N // bn)
        want = -(-sm_count // tiles)  # ranges that fill the card
        counts = sorted({-(-nk // spr) for spr in range(1, nk + 1)} & set(range(1, MAX_RANGES + 1)))
        r = next((c for c in counts if c >= want), counts[-1])
        spr = -(-nk // r)
        blocks = tiles * r
        if best is None or blocks > best[0]:
            best = (blocks, bn, spr)
        if blocks >= sm_count:
            break
    _, bn, spr = best
    return Plan("tiled", bn, bk, _ranges(K, bk, spr), min(spr, MAX_SLOTS))


def plan_of(x: torch.Tensor, w: torch.Tensor, sm_count: int) -> Plan:
    """The plan the wrapper runs for ``x @ w``: read from w's shape and x's
    type alone (x's rows and batch never reach :func:`plan`)."""
    K, N = w.shape[-2:]
    return plan(K, N, x.dtype, sm_count)


def _ranges(K: int, bk: int, spr: int) -> Tuple[Tuple[int, int], ...]:
    """K cut into ranges of ``spr`` stages of ``bk`` values, in order."""
    step = spr * bk
    return tuple((k0, min(K, k0 + step)) for k0 in range(0, K, step))


_sm_counts = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


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


def _launch(x: torch.Tensor, w: torch.Tensor, bias, pl: Plan = None,
            form: int = 0) -> torch.Tensor:
    """Validate, plan and launch ``mmtg_matmul``. ``pl``: a plan to run
    instead of :func:`plan`'s; ``form``: 1 the cluster form, 2 / 3 the
    one-block form with 64- / 128-row tiles (3: 64-column tiles only), 0 the
    launch's pick (the same bits; ``tools/matmul_plans`` times candidates and
    forms)."""
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
    pl = pl or plan_of(x, w, _sm_count(x.device))
    lead = x.shape[:-1]
    if pl.path == "small":  # single values: no padding, no alignment
        x = x.contiguous()
        wk, trans = _weight_layout(w, 1)
    else:
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
            _DTYPE_CODE[x.dtype], _PATH_CODE[pl.path], pl.bn, pl.spr, len(pl.ranges),
            pl.slots, form, torch.cuda.current_stream().cuda_stream)
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
