"""Whole-step decode kernel: all transformer layers of one decode step in one
launch.

PyTorch counterpart of :mod:`mmtg_tpu.ops.decode_megakernel`
(``decode_block_fused``). Per layer: LN1 → QKV product + bias → q scaled →
int8 quantize-append of the k/v rows → attention over the live cache prefix →
output projection + residual → LN2 → MLP with ``gelu_new`` → residual.
Returns the hidden state ``[B, D]`` BEFORE the final LayerNorm; the int8
caches and their scales are updated IN PLACE.

For CUDA tensors :func:`decode_block_fused` launches the hand-written kernel
``csrc/decode_block_fused.cu``: one persistent grid of blocks that all fit on
the card at once, walking the layers' stages with a grid barrier between
them; each weight tile of a product is owned by one block and read once a
step. :func:`plan` sets that grid and how the work is split over it; it is
pure Python, so the CPU tests check it. For CPU tensors the wrapper runs
:func:`decode_block_fused_plain`, the per-layer loop in plain PyTorch with the
same rounding points. The wrapper counts its launches in ``.launches``.

Scope, as in the JAX package: int8 split cache, full-precision weights of
the stream dtype. The kernel's own limits: ``head_dim <= 128`` and a multiple
of 16 (a lane reads 16 bytes of a head's int8 row), and a plan whose shared
memory fits a block (:func:`plan` raises when none does). The TPU kernel's
``D % 128`` and batch-multiple-of-8 limits are Mosaic's and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from mmtg_tpu_torch.kernels import _build
from mmtg_tpu_torch.ops.decode_attention import decode_attention_append_plain

# the order of the C entry point's `params` array
PARAM_KEYS = ("ln1_g", "ln1_b", "attn_w", "attn_b", "attn_proj_w", "attn_proj_b",
              "ln2_g", "ln2_b", "mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# csrc/decode_block_fused.cu: kThreads, kBatchGroup, kItemThreads
THREADS = 256
BATCH_GROUP = 64   # rows of the product input staged in shared memory at a time
ITEM_THREADS = 64  # threads that attend over one (batch row, head) item
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block can use on Hopper
SMEM_PER_SM = 233472     # bytes an SM has for its blocks
SMEM_RESERVED = 1024     # bytes the runtime keeps per block
SMEM_STATIC = 256        # room for the kernel's static shared memory
BLOCKS_PER_SM = (2, 1)   # tried in this order: the first whose plan fits
_RED_BYTES = 4096        # the warps' partial products (8 warps x 32 lanes x 4 f32)
_BIAS_BYTES = 1024       # a column tile's bias slice
# a dependent round trip to L2 under load, in bytes a block could stage from L2
# in that time: what an item's set-up and a split's partial sums cost beside
# their bytes
_LATENCY_BYTES = 16384


class Product(NamedTuple):
    """One product of a layer, ``out[B, N] = x[B, K] @ W[K, N]``, split into
    ``N // nt`` column tiles of ``nt`` columns and ``splits`` K ranges of
    ``K // splits`` rows. Work item ``i`` is (column tile ``i // splits``, K
    range ``i % splits``); block ``j`` of the grid owns items ``j, j + grid,
    ...``, loads their weight tiles once a step and multiplies them by all B
    rows. With ``splits > 1`` the ranges' partial sums go to scratch; the
    column tile's blocks wait for each other and each adds them in range
    order for its share of the tile's outputs."""
    name: str
    K: int
    N: int
    nt: int
    splits: int

    @property
    def kt(self) -> int:
        return self.K // self.splits

    @property
    def items(self) -> int:
        return self.N // self.nt * self.splits

    def per_block(self, grid: int) -> int:
        return -(-self.items // grid)


class Plan(NamedTuple):
    grid: int            # blocks, all resident at once
    blocks_per_sm: int
    smem: int            # dynamic shared memory a block, bytes
    wbuf: int            # one of the two weight buffers, bytes
    products: Tuple[Product, ...]  # qkv, proj, fc, mproj
    att_items: int       # (batch row, head) items of the attention stage


def items_of(prod: Product, grid: int, block: int):
    """The (column tile, K range) items block ``block`` owns, in its order."""
    return [(i // prod.splits, i % prod.splits) for i in range(block, prod.items, grid)]


def att_items_of(pl: Plan, n_head: int, block: int):
    """The (batch row, head) items block ``block`` attends over: four at a
    time (quarters of the block), item ``i`` to quarter ``i % (4 grid)``."""
    per = THREADS // ITEM_THREADS
    return [(i // n_head, i % n_head) for part in range(per)
            for i in range(block * per + part, pl.att_items, pl.grid * per)]


def split_order(prod: Product):
    """The K ranges ``[k0, k1)`` of one column tile in the order their partial
    sums are added (fixed: range order, whichever block adds them)."""
    return [(s * prod.kt, (s + 1) * prod.kt) for s in range(prod.splits)]


def _tile_bytes(p: Product, grid: int, e: int) -> int:
    # a block's tiles of one product: rows of nt values and 16 bytes of pad
    return p.per_block(grid) * p.kt * (p.nt * e + 16)


def _x_bytes(B: int, kt: int, e: int) -> int:
    rows = min(BATCH_GROUP, -(-B // 8) * 8)
    return rows * (kt * e + 16)


def _att_bytes(D: int, T: int, n_head: int, e: int) -> int:
    hd = D // n_head
    lanes = 1  # a lane reads 16 int8 codes: G lanes a head row, a power of two
    while lanes * 16 < hd:
        lanes *= 2
    stage = 2 * (-(-D // 16) * 16)  # the recomputed k and v codes
    rows = 2 * D * e                # the step's k and v rows
    mask = 4 * (-(-T // 4) * 4)     # the row's key mask
    groups = ITEM_THREADS // lanes
    return THREADS // ITEM_THREADS * (stage + rows + mask + 4 * groups * (2 + hd))


def _choose(K: int, N: int, name: str, B: int, grid: int, e: int, x_cap: int,
            w_cap: int) -> Product:
    """The (nt, splits) with the least on a block's critical path, in bytes:
    the input rows it stages (from L2), a quarter of its weight bytes (their
    load is issued two stages ahead), a round trip an item and, for a split
    product, its partial sums written and its share of them summed, and three
    more round trips (the fence, the count, the sum). A split product has at
    most one item a block: its blocks wait for each other."""
    best = None
    for nt in range(16, min(N, _BIAS_BYTES // e) + 1, 16):
        if N % nt:
            continue
        for splits in range(1, K // 16 + 1):
            if K % (16 * splits):
                continue
            p = Product(name, K, N, nt, splits)
            if _x_bytes(B, p.kt, e) > x_cap or _tile_bytes(p, grid, e) > w_cap:
                continue
            cnt = p.per_block(grid)
            if splits > 1 and cnt > 1:
                continue
            cost = cnt * (B * p.kt * e + p.kt * nt * e // 4 + _LATENCY_BYTES)
            if splits > 1:
                cost += B * nt * 4 + splits * (-(-B * nt // splits)) * 4 + 3 * _LATENCY_BYTES
            if best is None or cost < best[0]:
                best = (cost, p)
    if best is None:
        raise ValueError(f"decode_block_fused: no split of the {name} product "
                         f"[{K}, {N}] fits shared memory")
    return best[1]


def plan(B: int, D: int, L: int, T: int, n_head: int, dtype: torch.dtype,
         sm_count: int) -> Plan:
    """The grid and the split of the work over it. Pure Python: what the
    kernel runs is what this returns. Raises ValueError when no grid of one or
    two blocks an SM fits a block's shared memory."""
    e = 2 if dtype == torch.bfloat16 else 4
    shapes = (("qkv", D, 3 * D), ("proj", D, D), ("fc", D, 4 * D), ("mproj", 4 * D, D))
    # the attention's items, or the LayerNorm's gain, bias and row a warp
    other = max(_att_bytes(D, T, n_head, e), (THREADS // 32 + 2) * D * e)
    for bps in BLOCKS_PER_SM:
        grid = sm_count * bps
        budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // bps - SMEM_RESERVED) - SMEM_STATIC
        # the input rows of one item may take a quarter of the budget, a
        # block's tiles of one product half of what the work area leaves
        x_cap = budget // 4
        w_cap = (budget - max(other, x_cap + _RED_BYTES + _BIAS_BYTES)) // 2
        try:
            prods = tuple(_choose(K, N, name, B, grid, e, x_cap, w_cap)
                          for name, K, N in shapes)
        except ValueError:
            continue
        wbuf = max(_tile_bytes(p, grid, e) for p in prods)
        work = max(max(_x_bytes(B, p.kt, e) for p in prods) + _RED_BYTES + _BIAS_BYTES,
                   other)
        return Plan(grid, bps, 2 * wbuf + work, wbuf, prods, B * n_head)
    raise ValueError(f"decode_block_fused: B={B}, D={D} in {dtype} has no launch "
                     f"plan that fits {SMEM_PER_BLOCK} bytes of shared memory")


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


# what the C entry point returns when the grid cannot be co-resident
# (cudaErrorCooperativeLaunchTooLarge)
_NOT_RESIDENT = 720

# (device, stream) -> int32 words the kernel leaves as it needs them: the
# barrier's arrival word (each barrier adds 2**31 to it), then one count per
# column tile (back to 0 at the end of every split product)
_sync_words = {}


def _sync_buffer(device, n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _sync_words.get(key)
    if buf is None or buf.numel() < n:
        buf = _sync_words[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _launch(h_embed, params_h, k_cache, v_cache, k_scale, v_scale, key_mask,
            position: int, n_head: int, eps: float) -> torch.Tensor:
    """Validate, plan and launch ``mmtg_decode_block_fused``."""
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
    if D % n_head or D // n_head > 128 or (D // n_head) % 16:
        raise ValueError(f"decode_block_fused: D={D}, n_head={n_head} (needs "
                         "head_dim <= 128 and a multiple of 16)")
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
        if t.data_ptr() % 16:
            raise ValueError("decode_block_fused: storage must start on a "
                             "16-byte boundary")
    dev = h_embed.device
    pl = plan(B, D, L, T, n_head, dt,
              torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(h_embed)
    # the activations in the stream dtype (every value is rounded to it):
    # h, the LN output / ctx, qkv, the MLP row
    act = torch.empty(B, 9 * D, dtype=dt, device=dev)
    partial = torch.empty(max([p.splits * B * p.N for p in pl.products if p.splits > 1],
                              default=1), dtype=torch.float32, device=dev)
    sync = _sync_buffer(dev, 1 + max(p.N // p.nt for p in pl.products))
    lib = _build.load()
    ptrs = (ctypes.c_void_p * len(PARAM_KEYS))(
        *[params_h[k].data_ptr() for k in PARAM_KEYS])
    ints = [pl.grid, pl.smem, pl.wbuf]
    for p in pl.products:
        ints += [p.nt, p.splits]
    plan_arr = (ctypes.c_int * len(ints))(*ints)
    with torch.cuda.device(dev):
        err = lib.mmtg_decode_block_fused(
            h_embed.data_ptr(), ptrs, k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), act.data_ptr(), partial.data_ptr(), sync.data_ptr(),
            plan_arr, L, B, T, D, n_head, position, eps,
            1.0 / math.sqrt(D // n_head), _DTYPE_CODE[dt],
            torch.cuda.current_stream().cuda_stream)
    if err == _NOT_RESIDENT:
        raise RuntimeError(
            f"decode_block_fused: the card cannot hold the plan's {pl.grid} "
            f"blocks ({pl.blocks_per_sm} an SM, {pl.smem} bytes of shared "
            "memory each) at once; the grid barrier would deadlock")
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
