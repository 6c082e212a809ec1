"""The yardstick: published peaks of the card, and the work a cell's call
or step needs, counted from its shapes (operations and bytes), whatever
code does it.

A least time is the larger of the bytes at the memory rate (each input
read once, each output written once) and the operations at the peak rate
of their type. Copies, in the benchmark's own words, of the port's
``utils/roofline.py`` (peaks, ``train_flops_model``) and of the kernel
bounds of ``chip_smoke.bound``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

# NVIDIA data-sheet figures, dense, at the full power limit: bytes/s of HBM,
# bf16 tensor-core and float32 CUDA-core operations/s; matched by the prefix
# of torch.cuda.get_device_name()
PEAKS: Dict[str, Tuple[float, float, float]] = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 989e12, 67e12),
    "NVIDIA H100 PCIe": (2.0e12, 756e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 835e12, 60e12),
}


def peaks(kind: str) -> Dict[str, float]:
    """``{"bytes": B/s, "bfloat16": op/s, "float32": op/s}`` of the card;
    a card the table does not know raises ``ValueError``."""
    for k, (mem, bf16, f32) in PEAKS.items():
        if kind.startswith(k):
            return {"bytes": mem, "bfloat16": bf16, "float32": f32}
    raise ValueError(f"no published peaks for {kind!r} (known: {list(PEAKS)})")


def least(nbytes: float, ops: float, dtype: str, pk: Dict[str, float]) -> float:
    """Seconds: the larger of ``nbytes`` at the memory rate and ``ops`` at
    the peak of ``dtype``."""
    return max(nbytes / pk["bytes"], ops / pk[dtype])


# -- generation ----------------------------------------------------------------

def _dims(model: dict, data: dict):
    g = model["gpt2"]
    return (g["n_embd"], g["n_layer"], g["vocab_size"], g["n_head"],
            data["topic_prompt_length"], model["seq_len"],
            model["topic"]["input_dim"], model["topic"]["hidden_dim"],
            model["mm_att_out_dim"])


def generate_products(model: dict, data: dict, B: int, length: int
                      ) -> List[Tuple[int, int, int, int, int, bool]]:
    """Every dense product of one ``generate`` call that goes through the
    port's product (``ops/matmul``): ``(Z, M, K, N, bytes an element,
    bias)``, ``Z`` products of ``[M, K] @ [K, N]``. The encoder, the
    projector and the 16-token prefill once, then per step the projector,
    four products a layer and the LM head."""
    D, L, V, H, P, T, E, Hc, Eo = _dims(model, data)
    S = model["self_att_hidden_size"]
    nh = model["self_att_heads"]
    Pf = P + 1
    hd = D // H
    out = [(1, B, E, Hc, 2, True)]                       # topic channel
    out += [(1, T * B, E, 3 * Hc, 2, True)] * 2           # GRU input projections
    for _ in range(2):                                    # alpha attention
        out += [(1, B * T, S, S, 2, True)] * 3
        out += [(B * nh, T, S // nh, T, 4, False),        # scores in f32
                (B * nh, T, T, S // nh, 2, False)]
    out += [(T, 3 * B, Hc, model["mm_att_dim"], 2, False),  # beta scores
            (B * T, 1, 3, Hc, 2, False),                   # beta mix
            (1, B * T, Hc, Eo, 2, True)]                   # beta out
    out += [(1, B * Pf, Eo, 512, 2, True), (1, B * Pf, 512, D, 2, True)]
    for _ in range(L):                                    # prefill layers
        out += [(1, B * Pf, D, 3 * D, 2, True),
                (B * H, Pf, hd, Pf, 4, False), (B * H, Pf, Pf, hd, 2, False),
                (1, B * Pf, D, D, 2, False), (1, B * Pf, D, 4 * D, 2, True),
                (1, B * Pf, 4 * D, D, 2, False)]
    out += [(1, B * Pf, D, V, 2, False)]                  # prefill LM head
    step = [(1, B, Eo, 512, 2, True), (1, B, 512, D, 2, True)]
    step += [(1, B, D, 3 * D, 2, True), (1, B, D, D, 2, False),
             (1, B, D, 4 * D, 2, True), (1, B, 4 * D, D, 2, False)] * L
    step += [(1, B, D, V, 2, False)]
    return out + step * length


def product_least(products: Iterable, pk: Dict[str, float]) -> float:
    """The summed least time of products from :func:`generate_products`."""
    total = 0.0
    for Z, M, K, N, e, bias in products:
        nbytes = Z * (M * K + K * N + M * N) * e + (N * e if bias else 0)
        total += least(nbytes, 2.0 * Z * M * K * N,
                       "float32" if e == 4 else "bfloat16", pk)
    return total


def live_slots(tokens: torch.Tensor, prompt_len: int) -> torch.Tensor:
    """``[length]``: at decode step ``i`` (target position ``i + 1``), the
    cache slots whose key is live, summed over the rows: the prompt and
    [#START#], then each target token that is not [PAD] up to that
    position. ``tokens`` ``[B, 1 + length]``, the call's output."""
    live = (tokens[:, 1:] != 0).to(torch.int64).cumsum(1)  # [B, length]
    return (live + prompt_len + 1).sum(0)


def generate_flops(model: dict, data: dict, B: int, length: int,
                   slots: torch.Tensor) -> float:
    """Operations of one ``generate`` call: every dense product of
    :func:`generate_products`, the prefill's attention (inside those), the
    decode attention's two products over the live slots, the GRUs'
    recurrent products. Sampling, LayerNorms and other elementwise work are
    left out."""
    D, L, V, H, P, T, E, Hc, Eo = _dims(model, data)
    ops = sum(2.0 * Z * M * K * N
              for Z, M, K, N, _, _ in generate_products(model, data, B, length))
    ops += 2 * 2.0 * B * T * Hc * 3 * Hc                   # GRU h @ W_hh
    ops += 4.0 * D * L * float(slots.sum())               # q.k and p.v
    return ops


def decode_attention_least(model: dict, data: dict, B: int, slots: torch.Tensor,
                           pk: Dict[str, float], act: int = 2) -> float:
    """Least time of the decode attention of one call with an int8 cache:
    a layer a step reads q, the key mask up to the position, the live int8
    k and v rows and their f32 scales, the new k and v, and writes the
    context, the appended rows and their scales (``chip_smoke.py``'s
    count)."""
    D, L, V, H, P, *_ = _dims(model, data)
    total = 0.0
    for i, n in enumerate(slots.tolist()):
        pos = P + i + 1
        nbytes = (B * D * act + 2 * n * D + 4 * B * (pos + 1) + B * D * act
                  + 2 * 4 * n + 2 * B * D * act + 2 * B * D + 2 * 4 * B)
        total += least(nbytes, 4.0 * n * D, "bfloat16", pk)
    return L * total


# -- training ------------------------------------------------------------------

def train_flops_model(model: dict, data: dict, B: int) -> float:
    """Model operations of one train step: 3 x the forward products of
    rows of ``topic_prompt_length + target_length`` tokens (a layer and
    token ``24 d^2 + 4 T d``, the LM head ``2 d V``, the projector ``2 (E
    512 + 512 d)``), as ``utils/roofline.train_flops_model`` counts."""
    D, L, V, *_ = _dims(model, data)
    T = data["topic_prompt_length"] + data["max_seq_length"] + 1
    E = data["wenlan_emb_size"]
    per_tok = L * (24 * D * D + 4 * T * D) + 2 * D * V + 2 * (E * 512 + 512 * D)
    return 3.0 * B * T * per_tok


def train_attention_least(model: dict, data: dict, B: int,
                          pk: Dict[str, float]) -> float:
    """Least time of a step's attention kernels, forward and backward of
    the 12 layers (causal, every key live): the forward reads the q|k|v
    slab, its bias and the key bias and writes the context and the row
    log-sum-exp, ``4 hd`` operations a (query, key) pair; the backward
    reads those and the context's gradient and writes the slab's and the
    bias's gradients, ``10 hd`` a pair (``chip_smoke.py``'s count)."""
    D, L, V, H, *_ = _dims(model, data)
    T = data["topic_prompt_length"] + data["max_seq_length"] + 1
    hd = D // H
    pairs = B * H * T * (T + 1) / 2
    fwd_bytes = B * T * 3 * D * 2 + 3 * D * 2 + B * T * 4 + B * T * D * 2 \
        + B * H * T * 4
    bwd_bytes = fwd_bytes + B * T * D * 2 + B * T * 3 * D * 2 + 3 * D * 4
    return L * (least(fwd_bytes, 4.0 * hd * pairs, "bfloat16", pk)
                + least(bwd_bytes, 10.0 * hd * pairs, "bfloat16", pk))
