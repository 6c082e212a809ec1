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

Tensor parallelism keeps the one device's sums (:func:`shard_plan`). A
column-parallel shard ``[K, N / tp]`` runs the plan of the full ``[K, N]``
weight (``plan_shape``), so each column's tree does not depend on tp. A
row-parallel shard ``[K / tp, N]`` runs the ranges of the full plan that
its rows cover, in two modes of the kernel: ``partial_out`` returns the f32
fold before any rounding, and ``acc_in`` starts the fold from such a
partial, so rank r continues rank r - 1's fold and the last rank rounds once
(``models/gpt2.tp_sum``): ``((p0 + p1) + p2) + p3`` whether one card or
several compute it.
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
# the SMs whose plans a CPU tensor-parallel mesh is checked against (an H100
# SXM's): the plain products follow no plan
REFERENCE_SM_COUNT = 132


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


def plan_of(x: torch.Tensor, w: torch.Tensor, sm_count: int, plan_shape=None) -> Plan:
    """The plan the wrapper runs for ``x @ w``: read from w's shape and x's
    type alone (x's rows and batch never reach :func:`plan`); with
    ``plan_shape`` = (K, N) of the full weight, the plan of w as its shard
    (:func:`shard_plan`)."""
    K, N = w.shape[-2:]
    if plan_shape is None or tuple(plan_shape) == (K, N):
        return plan(K, N, x.dtype, sm_count)
    return shard_plan(K, N, x.dtype, sm_count, tuple(plan_shape))


@functools.lru_cache(maxsize=None)
def shard_plan(K: int, N: int, dtype: torch.dtype, sm_count: int,
               full: Tuple[int, int]) -> Plan:
    """The plan of a tensor-parallel shard ``[K, N]`` of a ``full`` ``(K_f,
    N_f)`` weight, such that every output's sum is the full product's.

    * A column shard (``K == K_f``) keeps the full plan's K ranges; only its
      column tile follows the shard (the first of :data:`TILE_WIDTHS` whose
      tiles x ranges fill the card, as :func:`plan` picks).
    * A row shard (``N == N_f``, ``K_f`` a multiple of K) runs, at each
      rank, the ranges of the full plan its K slice covers, in order: on the
      bf16 tiled path the slices must start and end on range boundaries
      (:func:`row_shards_align`; ``ValueError`` otherwise); the f32 path's
      one FMA chain over k simply continues from ``acc_in`` at any k.
    """
    Kf, Nf = full
    pf = plan(Kf, Nf, dtype, sm_count)
    if K == Kf:
        if pf.path == "small" or dtype == torch.float32 or N == Nf:
            return pf
        r = len(pf.ranges)
        best = None
        for bn in TILE_WIDTHS:
            blocks = -(-N // bn) * r
            if best is None or blocks > best[0]:
                best = (blocks, bn)
            if blocks >= sm_count:
                break
        return pf._replace(bn=best[1])
    if N != Nf or Kf % K:
        raise ValueError(f"shard_plan: [{K}, {N}] is neither a column nor a row "
                         f"shard of [{Kf}, {Nf}]")
    if not row_shards_align(Kf, Nf, dtype, sm_count, Kf // K):
        raise ValueError(
            f"shard_plan: the plan of [{Kf}, {Nf}] ({len(pf.ranges)} K ranges of "
            f"{pf.spr * pf.bk}) does not cut at the row shards' boundaries "
            f"(every {K} values): the shards cannot keep the one device's order")
    if pf.path == "tiled" and dtype != torch.float32:
        return pf._replace(ranges=_ranges(K, pf.bk, pf.spr))
    return pf._replace(ranges=((0, K),))


def row_shards_align(K: int, N: int, dtype: torch.dtype, sm_count: int, tp: int) -> bool:
    """Whether ``tp`` row shards of a ``[K, N]`` weight can fold the full
    product's sums in order: the f32 path (one FMA chain over k) at any cut,
    the bf16 tiled path where every shard boundary is a boundary of the full
    plan's K ranges; the small path (K <= :data:`SMALL_K`) never splits."""
    if K % tp:
        return False
    if tp == 1:
        return True
    pl = plan(K, N, dtype, sm_count)
    if pl.path == "small":
        return False
    if dtype == torch.float32:
        return True
    return (K // tp) % (pl.spr * pl.bk) == 0


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


def matmul_plain(x: torch.Tensor, w: torch.Tensor, bias=None, acc_in=None,
                 partial_out: bool = False, plan_shape=None) -> torch.Tensor:
    """``x @ w (+ bias)``: the product rounded to x's type, then the sum with
    the bias rounded once more. With ``acc_in`` (f32, ``[..., N]``) the f32
    product is added to it before the rounding; with ``partial_out`` the f32
    sum is returned, unrounded and without a bias (the kernel's two modes,
    :func:`matmul`). ``plan_shape`` is the kernel's: the plain sums follow no
    plan."""
    _check_modes(x, w, bias, acc_in, partial_out)
    if acc_in is None and not partial_out:
        y = x @ w
        return y if bias is None else y + bias
    y = x.float() @ w.float()
    if acc_in is not None:
        y = acc_in + y
    if partial_out:
        return y
    y = y.to(x.dtype)
    return y if bias is None else y + bias


def _check_modes(x, w, bias, acc_in, partial_out):
    """A partial has no bias (the last rank adds it); ``acc_in`` is f32 of
    the output's shape; neither mode takes the batched form."""
    if acc_in is None and not partial_out:
        return
    if w.dim() != 2:
        raise ValueError("matmul: acc_in / partial_out take w [K, N], not a batch")
    if partial_out and bias is not None:
        raise ValueError("matmul: partial_out returns the f32 fold: no bias")
    want = (*x.shape[:-1], w.shape[-1])
    if acc_in is not None and (acc_in.dtype != torch.float32
                               or tuple(acc_in.shape) != want):
        raise ValueError(f"matmul: acc_in {tuple(acc_in.shape)} {acc_in.dtype}: f32 "
                         f"{want} (the output's shape)")


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
            form: int = 0, acc_in=None, partial_out: bool = False,
            plan_shape=None) -> torch.Tensor:
    """Validate, plan and launch ``mmtg_matmul``. ``pl``: a plan to run
    instead of :func:`plan`'s (or :func:`shard_plan`'s for ``plan_shape``);
    ``form``: 1 the cluster form, 2 / 3 the one-block form with 64- / 128-row
    tiles (3: 64-column tiles only), 0 the launch's pick (the same bits;
    ``tools/matmul_plans`` times candidates and forms); ``acc_in`` /
    ``partial_out``: :func:`matmul`'s modes."""
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
    _check_modes(x, w, bias, acc_in, partial_out)
    for t in (w,) + tuple(t for t in (bias, acc_in) if t is not None):
        if t.device != x.device:
            raise ValueError("matmul: all tensors must be on one CUDA device")
    pl = pl or plan_of(x, w, _sm_count(x.device), plan_shape)
    if pl.path == "small" and (acc_in is not None or partial_out):
        raise ValueError(f"matmul: K = {K} takes the small path, which has no "
                         "acc_in / partial_out")
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
    out = torch.empty(*lead, N, dtype=torch.float32 if partial_out else x.dtype,
                      device=x.device)
    Z = x.shape[0] if batched else 1
    M = x.numel() // (Z * K)
    b = None if bias is None else bias.contiguous()
    acc = None if acc_in is None else acc_in.contiguous()
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mmtg_matmul(
            x.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), None if acc is None else acc.data_ptr(), int(partial_out),
            Z, M, N, K, M * K, K * N, M * N, int(trans),
            _DTYPE_CODE[x.dtype], _PATH_CODE[pl.path], pl.bn, pl.spr, len(pl.ranges),
            pl.slots, form, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mmtg_matmul")
    return out


def matmul(x: torch.Tensor, w: torch.Tensor, bias=None, acc_in=None,
           partial_out: bool = False, plan_shape=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N] (+ bias [N])`` → ``[..., N]`` in x's type, or
    batched (the attention's per-head products): ``x [Z, M, K] @ w [Z, K,
    N]``. ``w`` may be a transposed view (the tied LM head's ``wte.T``, the
    keys ``k.transpose(-1, -2)``): it is read in place where it is the
    transpose of a contiguous matrix.

    The tensor-parallel modes (w ``[K, N]``, the tiled path): ``acc_in`` (f32
    ``[..., N]``) is the fold the K ranges' partials are added to, before
    the first; ``partial_out`` returns that fold in f32, before the rounding
    and without a bias. ``plan_shape`` = (K, N) of the full weight whose
    shard w is (:func:`shard_plan`)."""
    if x.device.type == "cpu":
        return matmul_plain(x, w, bias, acc_in, partial_out)
    if x.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {x.device}")
    out = _launch(x, w, bias, acc_in=acc_in, partial_out=partial_out,
                  plan_shape=plan_shape)
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
