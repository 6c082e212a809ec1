"""The arithmetic order of the bf16 train-attention forward, on the CPU.

The tensor-core forward of ``csrc/train_attention.cu`` no longer soft-maxes a
whole row: it sweeps 64-key tiles once with a running maximum and a running
sum, multiplies the dropped-out UN-NORMALISED probabilities (rounded to the
slab's type) into an f32 accumulator, divides once at the end and writes
``lse = m + log l``; key tiles past the causal diagonal and tile pairs whose
segment-id ranges do not overlap are not visited at all. ``tiled_forward``
below is that order in plain PyTorch. It is held against the three plain
versions the kernels are compared with on the card, so the tolerance that
comparison uses (``chip_smoke.TRAIN_TOL``: 1e-5 in f32, 2e-2 in bf16) is
known to cover the new rounding point before any card is involved.

This is a study of that tolerance, not a test of the kernels: the mirror is
written here, uses the natural exponential, f32 bias adds and a running
maximum that starts at ``-inf``, where the source works in the base-2 domain
(``ex2.approx``) and adds the projection bias in bf16 pairs. The only
statement about the kernels themselves is the card sweep of
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from mmtg_tpu_torch.ops import train_attention as ta

TILE = 64
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def tiled_forward(q, k, v, dt, scale, seed, rate, bias=None, seg=None):
    """``q``, ``k``, ``v`` ``[B, H, T, hd]`` f32 holding values of dtype
    ``dt``; ``bias`` ``[B, T]`` f32 key bias or ``seg`` ``[B, T]`` int ids.
    Returns (ctx ``[B, H, T, hd]`` f32 before the final rounding, lse ``[B,
    H, T]``, the number of (query tile, key tile) pairs visited)."""
    B, H, T, hd = q.shape
    n = T // TILE
    keep = (ta.dropout_keep_mask(seed, B, H, T, rate) if rate > 0.0
            else torch.ones(B, H, T, T, dtype=torch.bool))
    inv_keep = ta._inv_keep(rate) if rate > 0.0 else 1.0
    ctx = torch.empty(B, H, T, hd)
    lse = torch.empty(B, H, T)
    pos = torch.arange(T)
    visited = 0
    for b in range(B):
        if seg is not None:
            lo = seg[b].view(n, TILE).min(dim=1).values
            hi = seg[b].view(n, TILE).max(dim=1).values
        for qt in range(n):
            rows = slice(qt * TILE, (qt + 1) * TILE)
            m = torch.full((H, TILE), -float("inf"))
            l = torch.zeros(H, TILE)
            o = torch.zeros(H, TILE, hd)
            for kc in range(qt + 1):  # tiles past the diagonal are skipped
                if seg is not None and not (hi[kc] >= lo[qt] and lo[kc] <= hi[qt]):
                    continue  # no id of one tile equals an id of the other
                visited += 1
                cols = slice(kc * TILE, (kc + 1) * TILE)
                s = torch.matmul(q[b, :, rows], k[b, :, cols].transpose(-1, -2)) * scale
                if seg is not None:
                    same = seg[b, rows, None] == seg[b, None, cols]
                    s = s + torch.where(same, 0.0, ta.NEG_INF)
                else:
                    s = s + bias[b, None, None, cols]
                s = torch.where(pos[None, cols] > pos[rows, None],
                                torch.tensor(ta.NEG_INF), s)
                m_new = torch.maximum(m, s.max(dim=-1).values)
                alpha = torch.exp(m - m_new)  # 0 on the first visited tile
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)  # the sum is taken BEFORE dropout
                pd = torch.where(keep[b, :, rows, cols], p * inv_keep,
                                 torch.zeros_like(p))
                o = o * alpha[..., None] + torch.matmul(pd.to(dt).float(), v[b, :, cols])
                m = m_new
            ctx[b, :, rows] = o / l[..., None]  # one divide at the end
            lse[b, :, rows] = m + torch.log(l)
    return ctx, lse, visited


def _inputs(kind, dt, rng):
    B, T, H, hd = 2, 256, 2, 16
    width = H * ta.SLAB if kind == "head_major" else 3 * H * hd
    qkv = torch.from_numpy(rng.standard_normal((B, T, width)).astype(np.float32) * 0.8)
    qb = torch.from_numpy(rng.standard_normal(width).astype(np.float32) * 0.1)
    if kind == "head_major":  # zero pad lanes past the true head width
        lanes = torch.arange(width) % ta.LANES
        qkv[..., lanes >= hd] = 0.0
        qb[lanes >= hd] = 0.0
    qkv, qb = qkv.to(dt), qb.to(dt)
    seed = torch.tensor([987654], dtype=torch.int32)
    if kind == "seg":
        # row 0 as a packer writes it: ascending ids, segments that start
        # inside a tile and run over tile borders, the pad slots' own id.
        # Queries 150..191 visit tile 0 (tile 2's ids span 1..2) and find it
        # fully masked; tile 3 (ids 2 and up) skips tiles 0 and 1 by their id
        # ranges. Row 1: arbitrary ids in no order (nothing skipped, masked
        # scores inside every tile).
        seg = torch.empty(B, T, dtype=torch.int32)
        seg[0, :40], seg[0, 40:150], seg[0, 150:236], seg[0, 236:] = 0, 1, 2, 2 ** 15
        seg[1] = torch.from_numpy(rng.integers(0, 3, T).astype(np.int32))
        return qkv, qb, seg, seed, H, hd
    bias = torch.zeros(B, T)
    bias[:, 236:] = ta.NEG_INF  # the key-padding tail
    bias[0, :70] = ta.NEG_INF   # row 0: tile 0 and the start of tile 1 are dead,
    # so queries 70..255 meet a fully masked first tile (running maximum -1e30,
    # p = 1 until a live key rescales it to 0). Queries 0..69 see no live key
    # at all: the one case where the kernels and the plain version differ by
    # design (the plain softmax then leaks onto keys past the diagonal, the
    # kernels never visit them), which the model never produces (key 0 is
    # always live) and which is left out of the comparison.
    return qkv, qb, bias, seed, H, hd


def _heads(kind, qkv, qb, H):
    B, T, _ = qkv.shape
    if kind == "head_major":
        return ((qkv + qb).view(B, T, H, 3, ta.LANES).permute(3, 0, 2, 1, 4).float())
    return ta._split_packed(qkv, qb, H)


PLAIN = {"packed": ta.mha_train_packed_plain, "seg": ta.mha_train_packed_seg_plain,
         "head_major": ta.mha_train_plain}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["packed", "seg", "head_major"])
def test_tiled_online_softmax_matches_plain(kind, dt, rate):
    rng = np.random.default_rng(5)
    qkv, qb, mask, seed, H, hd = _inputs(kind, dt, rng)
    scale = hd ** -0.5
    q, k, v = _heads(kind, qkv, qb, H)
    ctx, lse, visited = tiled_forward(
        q, k, v, dt, scale, seed, rate,
        bias=None if kind == "seg" else mask, seg=mask if kind == "seg" else None)
    got = ta._merge_heads(ctx, dt)
    ref = PLAIN[kind](qkv, qb, mask, seed, H, rate, scale)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got.float()).all()
    B, T = mask.shape
    has_live_key = torch.ones(B, T, dtype=torch.bool)
    if kind != "seg":
        has_live_key = torch.cumsum(mask == 0, dim=1) > 0
    err = (got.float() - ref.float()).abs().amax(dim=-1)
    assert err[has_live_key].max().item() <= TOL[dt]

    # the row statistics the backward is handed: lse = log sum_j exp(s_ij)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if kind == "seg":
        s = s + torch.where(mask[:, None, :, None] == mask[:, None, None, :], 0.0,
                            ta.NEG_INF)
    else:
        s = s + mask[:, None, None, :]
    i = torch.arange(T)
    s = s + torch.where(i[None, :] <= i[:, None], 0.0, ta.NEG_INF)
    want = torch.logsumexp(s, dim=-1)
    live = has_live_key[:, None, :].expand_as(want)
    assert (lse[live] - want[live]).abs().max().item() <= 1e-4
    assert (lse[~live] < -1e29).all()  # about -1e30

    n = T // TILE
    causal_pairs = B * n * (n + 1) // 2
    if kind == "seg":
        # row 0 skips tile pairs (3, 0) and (3, 1); row 1's ids skip nothing
        assert visited == causal_pairs - 2
    else:
        assert visited == causal_pairs


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_masked_first_tile_does_not_leak(dt):
    """Queries whose first visited tile is fully masked: the p = 1 of that
    tile must be rescaled to exactly 0 by the first live key, so moving the
    dead keys' VALUES must not move the context."""
    rng = np.random.default_rng(6)
    qkv, qb, bias, seed, H, hd = _inputs("packed", dt, rng)
    q, k, v = _heads("packed", qkv, qb, H)
    ctx, _, _ = tiled_forward(q, k, v, dt, hd ** -0.5, seed, 0.1, bias=bias)
    v2 = v.clone()
    v2[0, :, :70] += 100.0  # the dead keys of row 0
    ctx2, _, _ = tiled_forward(q, k, v2, dt, hd ** -0.5, seed, 0.1, bias=bias)
    assert torch.equal(ctx[0, :, 70:], ctx2[0, :, 70:])
    assert torch.equal(ctx[1], ctx2[1])
