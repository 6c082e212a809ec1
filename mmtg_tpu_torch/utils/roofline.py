"""Roofline accounting: a measured wall as a share of the card (the port's
own copy of :mod:`mmtg_tpu.utils.roofline`, keyed by CUDA card names).

``decode_hbm_util`` divides the modeled HBM bytes of one batched KV-cached
``generate`` call by its wall and the card's memory rate; ``train_mfu``
divides the model FLOPs of one train step by its wall and the card's bf16
tensor-core rate. The counts depend on the configuration and the dtypes
alone, never on which code path ran the call, so the per-layer decode and
the whole-step kernel (or two remat policies) are held to the same work.
The counts equal the JAX module's number for number.

Peaks: NVIDIA's published data-sheet figures (dense, without sparsity, at
the card's full power limit), keyed by the name
``torch.cuda.get_device_name()`` gives and matched by prefix. They are spec
figures, not a streaming rate measured on the card (the JAX module's v5e
entry is a measured one). A name the tables do not know raises
``ValueError``: a share is never reckoned against another card's peak.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 data sheet: SXM5 80 GB, PCIe 80 GB, NVL 94 GB
HBM_PEAK_GBPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}

BF16_PEAK_TFLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989.0,
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
}

# float32 on the CUDA cores (outside the tensor cores)
F32_PEAK_TFLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 67.0,
    "NVIDIA H100 PCIe": 51.0,
    "NVIDIA H100 NVL": 60.0,
}


def _peak(table: Dict[str, float], what: str, device_kind: str) -> float:
    for k, v in table.items():
        if device_kind.startswith(k):
            return v
    raise ValueError(f"no published {what} peak for the device {device_kind!r} "
                     f"(known: {', '.join(table)})")


def peak_hbm_gbps(device_kind: str) -> float:
    return _peak(HBM_PEAK_GBPS, "HBM", device_kind)


def peak_bf16_tflops(device_kind: str) -> float:
    return _peak(BF16_PEAK_TFLOPS, "bf16", device_kind)


def peak_f32_tflops(device_kind: str) -> float:
    return _peak(F32_PEAK_TFLOPS, "float32", device_kind)


def dtype_name(dtype) -> str:
    """A resolved dtype as the tables name it: ``torch.bfloat16`` →
    ``"bfloat16"``; the names themselves (``"model"``, ``"int8"``,
    ``"int4"``, ``"bfloat16"``, ``"float32"``) pass through. ``"auto"``
    raises: resolve it first (``decoding.resolve_cache_dtype`` /
    ``resolve_weight_dtype``)."""
    name = str(dtype).removeprefix("torch.")
    if name not in ("model", "int8", "int4", "bfloat16", "float32"):
        raise ValueError(f"no byte width for the dtype {dtype!r}: pass the "
                         "dtype the call ran with")
    return name


def gpt2_param_count(gcfg) -> int:
    """Parameter count of the decoder (matmul weights + embeddings)."""
    d, L, V, P = gcfg.n_embd, gcfg.n_layer, gcfg.vocab_size, gcfg.n_positions
    per_layer = (
        d * 3 * d + 3 * d          # qkv
        + d * d + d                # attn proj
        + d * 4 * d + 4 * d        # mlp fc
        + 4 * d * d + d            # mlp proj
        + 4 * d                    # 2 LayerNorms
    )
    return V * d + P * d + L * per_layer + 2 * d  # + final LN


def _dtype_bytes(name: str, model_bytes: int = 2) -> float:
    return {"model": model_bytes, "int8": 1, "int4": 0.5,
            "bfloat16": 2, "float32": 4}[dtype_name(name)]


def decode_bytes_model(
    mcfg, dcfg, B: int, length: int,
    cache_dtype: str = "int8", weight_dtype: str = "model",
    model_dtype: str = "bfloat16",
) -> Dict[str, float]:
    """Modeled HBM bytes moved by one batched KV-cached ``generate`` call:
    the decode loop's three first-order terms. Activations, the sampling
    tail and the one-time prefill / encoder are left out, so ``hbm_util``
    is a slight under-estimate."""
    g = mcfg.gpt2
    d, L, V = g.n_embd, g.n_layer, g.vocab_size
    mb = _dtype_bytes(model_dtype)
    cb = _dtype_bytes(cache_dtype, mb)
    wb = _dtype_bytes(weight_dtype, mb)

    # (1) KV-cache streaming: step t reads L × B × t × d × 2 (k and v),
    #     Σ_{t=1..length} t = length (length + 1) / 2.
    cache_stream = L * B * d * 2 * cb * (length * (length + 1) / 2)
    # (2) decode-weight reads: every step reads all matmul weights once
    #     (qkv, proj, fc, fc-proj per layer) + the LM head, which int8
    #     weights quantize with the rest.
    per_layer_w = (d * 3 * d + d * d + d * 4 * d + 4 * d * d)
    weight_read = (L * per_layer_w * wb + V * d * wb) * length
    # (3) cache append writes: L × B × d × 2 per step.
    cache_write = L * B * d * 2 * cb * length

    total = cache_stream + weight_read + cache_write
    return {
        "cache_stream_bytes": cache_stream,
        "weight_read_bytes": weight_read,
        "cache_write_bytes": cache_write,
        "total_bytes": total,
    }


def decode_hbm_util(
    mcfg, dcfg, B: int, length: int, wall_s: float, device_kind: str,
    cache_dtype: str = "int8", weight_dtype: str = "model",
    model_dtype: str = "bfloat16",
) -> Dict[str, float]:
    """→ {hbm_util, achieved_gbps, hbm_peak_gbps, *bytes}."""
    m = decode_bytes_model(mcfg, dcfg, B, length, cache_dtype,
                           weight_dtype, model_dtype)
    peak = peak_hbm_gbps(device_kind)
    achieved = m["total_bytes"] / wall_s / 1e9
    return {
        "hbm_util": round(achieved / peak, 3),
        "achieved_gbps": round(achieved, 1),
        "hbm_peak_gbps": peak,
        "modeled_bytes_gb": round(m["total_bytes"] / 1e9, 1),
        "cache_stream_gb": round(m["cache_stream_bytes"] / 1e9, 1),
        "weight_read_gb": round(m["weight_read_bytes"] / 1e9, 1),
    }


def train_flops_model(mcfg, dcfg, B: int) -> Dict[str, float]:
    """Modeled FLOPs of one MMTG train step (forward + backward, batch B).

    Per-token forward matmul FLOPs (2·m·n·k), sequences of
    ``topic_prompt_length + target_length`` tokens:
      per layer: qkv 6d² + attention 4·T·d + proj 2d² + MLP 16d²
      LM head: 2·d·V;  projector: 2·(E·512 + 512·d)
    Backward = 2× forward, so *model* FLOPs (the MFU numerator) = 3×
    forward; hardware FLOPs count one more forward for full-block remat.
    """
    g = mcfg.gpt2
    d, L, V = g.n_embd, g.n_layer, g.vocab_size
    T = dcfg.topic_prompt_length + dcfg.target_length
    E = dcfg.wenlan_emb_size

    per_tok_layer = 24 * d * d + 4 * T * d
    per_tok = L * per_tok_layer + 2 * d * V + 2 * (E * 512 + 512 * d)
    fwd = B * T * per_tok
    return {
        "fwd_flops": fwd,
        "model_flops": 3 * fwd,
        "hw_flops": 4 * fwd,
        "tokens": B * T,
    }


def train_mfu(
    mcfg, dcfg, B: int, step_s: float, device_kind: str, remat: bool = True
) -> Dict[str, float]:
    """→ {mfu, hw_flops_util, achieved_model_tflops, peak_bf16_tflops, ...}.

    ``hw_flops_util`` counts the full-block re-forward whenever ``remat``,
    as the JAX module does; under a ``save_*`` policy the re-forward skips
    what the policy keeps, so it overstates that run's work. ``mfu`` does
    not depend on remat."""
    m = train_flops_model(mcfg, dcfg, B)
    peak = peak_bf16_tflops(device_kind) * 1e12
    model_rate = m["model_flops"] / step_s
    hw_rate = (m["hw_flops"] if remat else m["model_flops"]) / step_s
    return {
        "mfu": round(model_rate / peak, 3),
        "hw_flops_util": round(hw_rate / peak, 3),
        "achieved_model_tflops": round(model_rate / 1e12, 1),
        "peak_bf16_tflops": peak / 1e12,
        "model_flops_per_step": m["model_flops"],
        "tokens_per_step": m["tokens"],
    }
