"""Fused causal self-attention for the train step, forward and backward.

PyTorch counterparts of three functions of :mod:`mmtg_tpu.ops.train_attention`,
one computation with two options (where a head sits in the slab, what masks
a score):

* :func:`mha_train_packed` — the standard GPT-2 ``c_attn`` slab ``qkv [B, T,
  3·H·hd]`` (q all heads | k all heads | v all heads) with an additive
  ``[B, T]`` f32 key bias;
* :func:`mha_train_packed_seg` — the same slab with ``[B, T]`` int32 segment
  ids instead: ``i`` attends ``j`` iff ``seg[i] == seg[j]`` and ``j <= i``
  (sequence packing, :mod:`mmtg_tpu_torch.pack`);
* :func:`mha_train` — the head-major slab ``[B, T, H·384]`` (per head ``q | k
  | v``, each zero-padded from the true head width to 128; made by
  :func:`pad_qkv_weights`) with the key bias; context ``[B, T, H·128]``.

Each adds the projection bias inside, soft-maxes in f32, applies seeded
attention dropout, and has a gradient that recomputes the probabilities and
the same dropout bits and returns ``dqkv`` in the slab's layout plus the
projection-bias gradient. The ``[B, H, T, T]`` probabilities never reach
device memory.

Each is a ``torch.autograd.Function``: for CUDA tensors its forward and its
backward launch the hand-written kernels of ``csrc/train_attention.cu`` (and
raise if they cannot); for CPU tensors it runs its ``*_plain`` version, the
same math in plain differentiable PyTorch. ``<function>.fwd_launches`` /
``.bwd_launches`` count the kernel launches. For selective remat
(:mod:`mmtg_tpu_torch.models.gpt2`'s ``REMAT_POLICIES``),
:func:`attention_keep` runs a forward outside autograd and keeps the context
(and a kernel's row log-sum-exp), and :func:`attention_replay` later
differentiates that call from what was kept, with no second forward launch.

The source holds two designs, chosen by the slab's dtype and by nothing else:

* bf16 — tensor cores (``wgmma``, one warpgroup a 64-row tile). What bounds
  it is instruction issue on the scores (mask, exponential, the dropout hash:
  about 20 instructions an element), not the products and not the bytes; so
  the scores never leave the registers: the forward is one sweep over the key
  tiles with an online softmax whose dropped-out, UN-NORMALISED probabilities
  go straight from the accumulator to the next product, and the backward
  computes the scores transposed where it needs them transposed. Shared
  memory holds a ring of 8-16 KB bf16 tiles and does not grow with T. The
  context differs from the plain version's by one bf16 rounding of an
  un-normalised probability: at most one bf16 step of the context's own
  value (1.6e-2 where |ctx| lies between 2 and 4), no longer bit for bit.
* f32 — CUDA-core FMAs on f32 tiles in shared memory (TF32 would lose the
  1e-5 agreement with the plain version that the f32 checks rely on). What
  bounds it is the FMA rate and shared-memory loads; its forward keeps the
  scores of at most 512 keys, a ``[64, 512]`` block, in shared memory, and
  takes longer rows in two sweeps (a running max and sum, then the
  probabilities chunk by chunk).

Both take T up to 1024 (``n_positions``), a multiple of 128.

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

from typing import NamedTuple, Optional

import torch

from mmtg_tpu_torch.kernels import _build

NEG_INF = -1e30
MAX_T = 1024  # the longest row the kernels take
LANES = 128  # padded per-head width of the head-major slab
SLAB = 3 * LANES  # one head's q | k | v
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


def _attend_plain(q, k, v, mask_term, seed, dropout_rate, scale, dt):
    """``q``, ``k``, ``v`` ``[B, H, T, hd]`` f32 holding values of dtype
    ``dt``; ``mask_term`` f32, broadcastable to the ``[B, H, T, T]`` scores
    (the causal term is added here). Returns ctx ``[B, H, T, hd]`` f32."""
    B, H, T, _ = q.shape
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + mask_term
    i = torch.arange(T, device=q.device)
    s = s + torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).to(s.dtype)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, B, H, T, dropout_rate)
        p = torch.where(keep, p * _inv_keep(dropout_rate), torch.zeros_like(p))
    return torch.matmul(p.to(dt).float(), v)


def _split_packed(qkv, qkv_bias, n_head):
    B, T, S = qkv.shape
    hd = S // (3 * n_head)
    # each [B, H, T, hd], slab-dtype values held in f32
    return ((qkv + qkv_bias).view(B, T, 3, n_head, hd).permute(2, 0, 3, 1, 4)
            .float())


def _merge_heads(ctx, dt):
    B, H, T, hd = ctx.shape
    return ctx.transpose(1, 2).reshape(B, T, H * hd).to(dt)


def mha_train_packed_plain(qkv, qkv_bias, bias, seed, n_head: int,
                           dropout_rate: float = 0.0, scale: float = 1.0):
    """Plain differentiable PyTorch version (any device): f32 scores and
    softmax, products on values of the slab's dtype with f32 accumulation.
    ``qkv`` ``[B, T, 3·H·hd]``, ``qkv_bias`` ``[3·H·hd]``, ``bias`` ``[B, T]``
    f32 additive key bias, ``seed`` int32 ``[1]``. Returns ctx ``[B, T,
    H·hd]`` in the slab's dtype."""
    q, k, v = _split_packed(qkv, qkv_bias, n_head)
    ctx = _attend_plain(q, k, v, bias[:, None, None, :], seed, dropout_rate,
                        scale, qkv.dtype)
    return _merge_heads(ctx, qkv.dtype)


def mha_train_packed_seg_plain(qkv, qkv_bias, seg, seed, n_head: int,
                               dropout_rate: float = 0.0, scale: float = 1.0):
    """Plain version of :func:`mha_train_packed_seg`: as
    :func:`mha_train_packed_plain` with ``seg`` ``[B, T]`` int32 segment ids
    (equality of arbitrary ids, no order assumed) instead of the key bias."""
    q, k, v = _split_packed(qkv, qkv_bias, n_head)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    term = torch.where(same, 0.0, NEG_INF).to(torch.float32)
    ctx = _attend_plain(q, k, v, term, seed, dropout_rate, scale, qkv.dtype)
    return _merge_heads(ctx, qkv.dtype)


def mha_train_plain(qkv, qkv_bias, bias, seed, n_head: int,
                    dropout_rate: float = 0.0, scale: float = 1.0):
    """Plain version of :func:`mha_train`: ``qkv`` ``[B, T, H·384]`` head-major
    (per head ``q | k | v``, 128 lanes each), ``qkv_bias`` ``[H·384]``,
    ``bias`` ``[B, T]`` f32. All 128 lanes take part, as in the kernel; with
    zero pad lanes they add nothing. Returns ctx ``[B, T, H·128]``."""
    B, T, _ = qkv.shape
    q, k, v = ((qkv + qkv_bias).view(B, T, n_head, 3, LANES)
               .permute(3, 0, 2, 1, 4).float())
    ctx = _attend_plain(q, k, v, bias[:, None, None, :], seed, dropout_rate,
                        scale, qkv.dtype)
    return _merge_heads(ctx, qkv.dtype)


def pad_qkv_weights(attn_w, attn_b, n_head: int, head_dim: int):
    """``[D, 3·H·hd]`` QKV weight and ``[3·H·hd]`` bias → ``[D, H·384]`` /
    ``[H·384]`` head-major with zero pad columns per head (``[q_h | k_h |
    v_h]``, each ``hd`` → 128), so the projection emits :func:`mha_train`'s
    slab directly. Differentiable."""
    if head_dim > LANES:
        raise ValueError(f"pad_qkv_weights: head_dim {head_dim} > {LANES}")
    D = attn_w.shape[0]
    pad = (0, LANES - head_dim)
    w = torch.nn.functional.pad(attn_w.reshape(D, 3, n_head, head_dim), pad)
    b = torch.nn.functional.pad(attn_b.reshape(3, n_head, head_dim), pad)
    # [D, 3, H, 128] -> [D, H, 3, 128] -> [D, H*384]
    return (w.transpose(1, 2).reshape(D, n_head * SLAB),
            b.transpose(0, 1).reshape(n_head * SLAB))


def pad_proj_weights(proj_w, n_head: int, head_dim: int):
    """``[H·hd, D]`` attention output projection → ``[H·128, D]`` with zero
    pad rows, consuming :func:`mha_train`'s padded context. Differentiable."""
    if head_dim > LANES:
        raise ValueError(f"pad_proj_weights: head_dim {head_dim} > {LANES}")
    D = proj_w.shape[1]
    w = torch.nn.functional.pad(proj_w.reshape(n_head, head_dim, D),
                                (0, 0, 0, LANES - head_dim))
    return w.reshape(n_head * LANES, D)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(fn, qkv, qkv_bias, mask, seed, n_head):
    """Raise on what the kernels do not take; returns (B, T, hd), ``hd`` the
    head width the kernel works on (128 for the head-major slab)."""
    name = fn.__name__
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: qkv dtype {qkv.dtype} not f32/bf16")
    if fn.head_major:
        if qkv.dim() != 3 or qkv.shape[-1] != n_head * SLAB:
            raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not "
                             f"[B, T, {n_head}*{SLAB}]")
        hd = LANES
    else:
        if qkv.dim() != 3 or qkv.shape[-1] % (3 * n_head):
            raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not "
                             f"[B, T, 3*{n_head}*hd]")
        hd = qkv.shape[-1] // (3 * n_head)
        if hd > 128 or hd % 8:
            raise ValueError(f"{name}: head_dim {hd} (needs a multiple of 8, "
                             "at most 128)")
    B, T, S = qkv.shape
    if T % 128 or T > MAX_T:
        # up to GPT-2's n_positions. bf16: the tensor-core kernels hold a ring
        # of tiles and [T] words of mask and row statistics (under 120 KB at
        # T=1024). f32: the forward holds the scores of at most 512 keys
        # (199 KB at 128 lanes) and takes longer rows in chunks; its dk/dv
        # kernel holds 203 KB at T=1024.
        raise ValueError(f"{name}: T={T} (the caller pads to a multiple of "
                         f"128, at most {MAX_T})")
    if B * n_head * T >= 2 ** 31:
        raise ValueError(f"{name}: B*H*T must stay below 2**31")
    if qkv_bias.shape != (S,) or qkv_bias.dtype != qkv.dtype:
        raise TypeError(f"{name}: qkv_bias must be [{S}] in qkv's dtype")
    mask_dtype = torch.int32 if fn.seg else torch.float32
    if mask.shape != (B, T) or mask.dtype != mask_dtype:
        raise TypeError(f"{name}: {'seg' if fn.seg else 'bias'} must be "
                        f"[B, T] {mask_dtype}")
    if seed.numel() != 1 or seed.dtype != torch.int32:
        raise TypeError(f"{name}: seed must be one int32")
    for t in (qkv, qkv_bias, mask, seed):
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"{name}: all tensors must be contiguous and on "
                             "one CUDA device")
    if qkv.dtype == torch.bfloat16:
        _check_aligned(name, qkv, qkv_bias)
    return B, T, hd


def _check_aligned(name, *tensors):
    """The bf16 kernels move 16 bytes a thread: a view that starts off a
    16-byte boundary cannot be taken."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor storage must start on a 16-byte "
                             "boundary")


def _dropout_args(rate: float):
    if rate > 0.0:
        return _inv_keep(rate), dropout_threshold(rate), 1
    return 1.0, 0, 0


def _launch_forward(fn, qkv, qkv_bias, mask, seed, n_head, dropout_rate, scale):
    """One launch of ``fn``'s forward kernel: (ctx, lse ``[B, H, T]`` f32, the
    rows' log-sum-exp that the backward kernel reads)."""
    B, T, hd = _check(fn, qkv, qkv_bias, mask, seed, n_head)
    out = torch.empty((B, T, n_head * hd), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, n_head, T), dtype=torch.float32, device=qkv.device)
    inv_keep, thr, drop = _dropout_args(dropout_rate)
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        err = lib.mmtg_mha_train_fwd(
            qkv.data_ptr(), qkv_bias.data_ptr(), mask.data_ptr(),
            seed.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, T, n_head, hd, int(fn.head_major), int(fn.seg), scale,
            inv_keep, thr, drop, _DTYPE_CODE[qkv.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"{fn.__name__} forward")
    fn.fwd_launches += 1
    return out, lse


class _MhaTrain(torch.autograd.Function):
    """The kernels under autograd (CUDA tensors only). ``fn`` is the public
    function that was called: it names the slab layout (``fn.head_major``)
    and the mask (``fn.seg``), and its launch counters are the ones bumped.
    ``kept``: the ``(ctx, lse)`` of an earlier forward launch on the same
    inputs (:func:`attention_replay`), returned without launching again."""

    @staticmethod
    def forward(ctx, fn, qkv, qkv_bias, mask, seed, n_head, dropout_rate, scale,
                kept=None):
        if kept is None:
            out, lse = _launch_forward(fn, qkv, qkv_bias, mask, seed, n_head,
                                       dropout_rate, scale)
            res = out
        else:
            out, lse = kept
            res = out.view_as(out)
        ctx.save_for_backward(qkv, qkv_bias, mask, seed, out, lse)
        ctx.cfg = (fn, n_head, out.shape[-1] // n_head, dropout_rate, scale)
        return res

    @staticmethod
    def backward(ctx, dout):
        qkv, qkv_bias, mask, seed, out, lse = ctx.saved_tensors
        fn, n_head, hd, dropout_rate, scale = ctx.cfg
        B, T, S = qkv.shape
        dout = dout.contiguous()
        if dout.dtype != qkv.dtype or dout.device != qkv.device:
            raise TypeError(f"{fn.__name__}: d(ctx) must match qkv's dtype "
                            "and device")
        if dout.dtype == torch.bfloat16:
            _check_aligned(fn.__name__, dout)
        dqkv = torch.empty_like(qkv)
        dsum = torch.empty_like(lse)
        dqb = torch.zeros(S, dtype=torch.float32, device=qkv.device)
        inv_keep, thr, drop = _dropout_args(dropout_rate)
        lib = _build.load()
        with torch.cuda.device(qkv.device):
            err = lib.mmtg_mha_train_bwd(
                qkv.data_ptr(), qkv_bias.data_ptr(), mask.data_ptr(),
                seed.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), dqkv.data_ptr(),
                dqb.data_ptr(), B, T, n_head, hd, int(fn.head_major),
                int(fn.seg), scale, inv_keep, thr, drop,
                _DTYPE_CODE[qkv.dtype],
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{fn.__name__} backward")
        fn.bwd_launches += 1
        # a key bias gets a zero gradient, segment ids and the seed none (as
        # the JAX VJPs)
        dmask = (torch.zeros_like(mask)
                 if not fn.seg and ctx.needs_input_grad[3] else None)
        return (None, dqkv, dqb.to(qkv_bias.dtype), dmask, None, None, None,
                None, None)


class KeptAttention(NamedTuple):
    """What :func:`attention_keep` keeps of one attention forward for its
    backward: the context, and the kernels' ``lse`` (``[B, H, T]`` f32,
    1/32 of a bf16 context's bytes at 64 lanes a head; the JAX VJP derives it
    again from qkv, here the backward kernel reads it), or, for a plain
    version, its autograd ``graph`` ``(ctx, qkv leaf, qkv_bias leaf)``."""

    out: torch.Tensor
    lse: Optional[torch.Tensor] = None
    graph: Optional[tuple] = None


class _KeptGraph(torch.autograd.Function):
    """A plain version's kept context, differentiated through its kept graph."""

    @staticmethod
    def forward(ctx, graph, qkv, qkv_bias):
        ctx.graph = graph
        return graph[0].detach()

    @staticmethod
    def backward(ctx, dout):
        out, q, b = ctx.graph
        ctx.graph = None
        dq, db = torch.autograd.grad(out, (q, b), dout)
        return None, dq, db


def attention_keep(attend, qkv, qkv_bias, mask, seed, n_head: int,
                   dropout_rate: float = 0.0, scale: float = 1.0):
    """``attend(qkv, qkv_bias, mask, seed, ...)`` — one of the three functions
    or a plain version — run outside autograd. Returns (ctx, :class:`
    KeptAttention`): with it :func:`attention_replay` differentiates this
    call later without running its forward again. A kernel (CUDA tensors)
    keeps its ``ctx`` and ``lse``; a plain version keeps its graph (every
    intermediate it saves, the ``[B, H, T, T]`` probabilities too)."""
    if getattr(attend, "plain", None) is not None and qkv.device.type == "cuda":
        out, lse = _launch_forward(attend, qkv, qkv_bias, mask, seed, n_head,
                                   float(dropout_rate), float(scale))
        return out, KeptAttention(out, lse)
    with torch.enable_grad():
        q = qkv.detach().requires_grad_()
        b = qkv_bias.detach().requires_grad_()
        out = attend(q, b, mask, seed, n_head, dropout_rate, scale)
    return out.detach(), KeptAttention(out.detach(), graph=(out, q, b))


def attention_replay(attend, kept: KeptAttention, qkv, qkv_bias, mask, seed,
                     n_head: int, dropout_rate: float = 0.0, scale: float = 1.0):
    """The context of the :func:`attention_keep` call that made ``kept``, as
    a function of ``qkv`` and ``qkv_bias`` (the same values, kept or
    recomputed), with no forward launch: the backward kernel reads ``kept``'s
    context and ``lse``, or a plain version's kept graph runs backward."""
    if kept.graph is not None:
        return _KeptGraph.apply(kept.graph, qkv, qkv_bias)
    return _MhaTrain.apply(attend, qkv, qkv_bias, mask, seed, n_head,
                           float(dropout_rate), float(scale), (kept.out, kept.lse))


def _dispatch(fn, qkv, qkv_bias, mask, seed, n_head, dropout_rate, scale):
    if qkv.device.type == "cpu":
        return fn.plain(qkv, qkv_bias, mask, seed, n_head, dropout_rate, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {qkv.device}")
    return _MhaTrain.apply(fn, qkv, qkv_bias, mask, seed, n_head,
                           float(dropout_rate), float(scale))


def mha_train_packed(qkv, qkv_bias, bias, seed, n_head: int,
                     dropout_rate: float = 0.0, scale: float = 1.0):
    """Fused causal multi-head attention over a standard-order qkv slab.

    ``qkv`` ``[B, T, 3·H·hd]`` f32/bf16 (``a @ attn_w``, no bias yet),
    ``qkv_bias`` ``[3·H·hd]`` in the same dtype, ``bias`` ``[B, T]`` f32
    additive key bias (0 live, -1e30 padded), ``seed`` one int32 on qkv's
    device (read only when ``dropout_rate > 0``). T is a multiple of 128.
    Returns ctx ``[B, T, H·hd]``. Differentiable in ``qkv`` and ``qkv_bias``."""
    return _dispatch(mha_train_packed, qkv, qkv_bias, bias, seed, n_head,
                     dropout_rate, scale)


def mha_train_packed_seg(qkv, qkv_bias, seg, seed, n_head: int,
                         dropout_rate: float = 0.0, scale: float = 1.0):
    """:func:`mha_train_packed` with segment masking instead of a key bias:
    ``seg`` is ``[B, T]`` int32; token ``i`` attends token ``j`` iff ``seg[i]
    == seg[j]`` and ``j <= i``. The ids are arbitrary (equality is all that
    is tested); ``seg`` is data and gets no gradient."""
    return _dispatch(mha_train_packed_seg, qkv, qkv_bias, seg, seed, n_head,
                     dropout_rate, scale)


def mha_train(qkv, qkv_bias, bias, seed, n_head: int,
              dropout_rate: float = 0.0, scale: float = 1.0):
    """Fused causal multi-head attention over a head-major qkv slab.

    ``qkv`` ``[B, T, H·384]``: head ``h`` owns columns ``[h·384, (h+1)·384)``
    as ``[q_h | k_h | v_h]``, each zero-padded from the true head width to
    128 (fold the padding into the QKV weights with :func:`pad_qkv_weights`);
    ``qkv_bias`` ``[H·384]`` in the same layout; ``bias`` ``[B, T]`` f32 key
    bias; ``scale`` normally ``1/sqrt(true head width)``. Returns ctx ``[B,
    T, H·128]``, whose pad lanes are zero whenever v's are; the gradient
    writes every element of ``dqkv``, pad lanes too (zero when the pad lanes
    of the slab, the bias and ``d(ctx)`` are zero)."""
    return _dispatch(mha_train, qkv, qkv_bias, bias, seed, n_head,
                     dropout_rate, scale)


for _fn, _plain, _head_major, _seg in (
        (mha_train_packed, mha_train_packed_plain, False, False),
        (mha_train_packed_seg, mha_train_packed_seg_plain, False, True),
        (mha_train, mha_train_plain, True, False)):
    _fn.plain, _fn.head_major, _fn.seg = _plain, _head_major, _seg
    _fn.fwd_launches = 0
    _fn.bwd_launches = 0
