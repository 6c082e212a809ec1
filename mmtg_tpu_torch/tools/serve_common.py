"""Shared set-up of the serving and latency tools: the model, the WenLan
table, synthetic request payloads keyed by ``serve.SAMPLE_KEYS``, the flags
the port adds to every tool, and the per-scenario record of what the
service ran.

The table and the payloads are the JAX helpers' numpy draws, array for
array (``np.random.default_rng(0)`` for the table, ``default_rng(i)`` for
payload ``i``), so both packages' tools send the same traffic. The weights
are the port's seeded init (``params.init_params(mcfg, seed=0)``), in bf16
on the device.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, ContextManager, Dict, Optional, Tuple

import numpy as np
import torch

from mmtg_tpu_torch.configs import DataConfig, GenerateConfig, ModelConfig

# ``observe(label)``: a context manager the tools enter around each measured
# scenario (chip_smoke.py counts the kernels' launches in it)
Observe = Callable[[str], ContextManager]


def add_port_args(ap, attn_impl: bool = True) -> None:
    """The flags the port adds to the JAX tools: ``--device`` and (for the
    tools that build a service) ``--attn-impl``."""
    ap.add_argument("--device", default=None, type=str,
                    help="torch device (default: cuda; pass 'cpu' to run "
                         "without a GPU)")
    if attn_impl:
        ap.add_argument("--attn-impl", default="auto",
                        choices=["auto", "kernel", "fused"],
                        help="decode step: 'kernel' = the per-layer loop "
                             "(what 'auto' resolves to), 'fused' = the "
                             "whole-step kernel where its scope holds (int8 "
                             "cache, full-precision weights; "
                             "decoding.resolve_attn_impl)")


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def sync(device: torch.device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_table(mcfg: ModelConfig, dcfg: DataConfig,
               rng: np.random.Generator) -> np.ndarray:
    """The random WenLan table ``[vocab, wenlan_emb_size]`` (float64), drawn
    from ``rng`` as the JAX tools draw it."""
    return rng.standard_normal((mcfg.gpt2.vocab_size, dcfg.wenlan_emb_size))


def build_model(cache_dtype: str = "int8", device=None,
                mcfg: Optional[ModelConfig] = None,
                dcfg: Optional[DataConfig] = None,
                attn_impl: str = "auto", dtype: torch.dtype = torch.bfloat16,
                weights: Optional[Tuple[Dict, Dict]] = None):
    """Seeded model + table + the canonical GenerateConfig (length
    ``dcfg.max_seq_length``, 220 at the default config) →
    ``(params, const, mcfg, dcfg, gcfg)``. ``mcfg`` / ``dcfg`` default to
    the full-size model; ``weights`` = ``(params, const)`` built before by
    this function for the same configs is used as it is."""
    if (mcfg is None) != (dcfg is None):
        raise ValueError("pass mcfg and dcfg together")
    if mcfg is None:
        mcfg, dcfg = ModelConfig(), DataConfig()
    gcfg = GenerateConfig(cache_dtype=cache_dtype, attn_impl=attn_impl,
                          length=dcfg.max_seq_length)
    if weights is not None:
        params, const = weights
        return params, const, mcfg, dcfg, gcfg
    from mmtg_tpu_torch.params import init_params

    params = init_params(mcfg, seed=0, dtype=dtype, device=device)
    table = make_table(mcfg, dcfg, np.random.default_rng(0))
    const = {"wenlan_table": torch.from_numpy(table).to(device, dtype)}
    return params, const, mcfg, dcfg, gcfg


def make_payload(i: int, dcfg: DataConfig, mcfg: ModelConfig) -> dict:
    """One synthetic request sample keyed per serve.SAMPLE_KEYS."""
    P = dcfg.topic_prompt_length
    r = np.random.default_rng(i)
    return {
        "topic_ids": r.integers(103, 8000, (P,)).astype(np.int32),
        "tpw_attention_mask": np.ones((P,), np.int32),
        "tpw_type_ids": np.ones((P,), np.int32),
        "topic_emb": r.standard_normal((mcfg.topic.input_dim,)).astype(
            np.float32
        ),
        "img_embs": r.standard_normal(
            (mcfg.seq_len, mcfg.image.input_dim)
        ).astype(np.float32),
        "r_embs": r.standard_normal(
            (mcfg.seq_len, mcfg.text.input_dim)
        ).astype(np.float32),
    }


# The decode shapes warmed in this process. A warm-up pays only first-touch
# costs (library handles, the allocator's blocks; the port compiles nothing
# per shape), so a tool run after another in one process (chip_smoke.py
# phase 23 runs them all in one) skips the warm-ups of shapes warmed before,
# while a tool run alone warms every shape it meets.
_WARMED: set = set()


def decode_key(params, device, batch: int, length: int, gcfg: GenerateConfig,
               n_embd: int) -> tuple:
    """What a decode call's first-touch costs depend on: the weights (by
    identity), the device, the batch, the length, and the dtypes and decode
    step ``gcfg`` resolves to at this batch (as ``decoding.generate`` does)."""
    from mmtg_tpu_torch.decoding import (resolve_attn_impl, resolve_cache_dtype,
                                         resolve_weight_dtype)

    return (id(params), str(device), batch, length,
            resolve_weight_dtype(gcfg, batch), resolve_cache_dtype(gcfg, batch),
            resolve_attn_impl(gcfg, n_embd, batch_size=batch))


def warm(key: tuple, call: Callable[[], object]) -> bool:
    """``call()``, a warm-up decode, unless one of shape ``key`` ran in this
    process; returns whether it ran."""
    if key in _WARMED:
        return False
    call()
    _WARMED.add(key)
    return True


def warm_service(svc, buckets=None) -> None:
    """``svc.warmup(bucket=b, streams=False)`` for each of ``buckets``
    (default: all the service's) at a shape not warmed in this process (a
    chunked decode runs the one-shot decode's kernels at its shapes: this
    warms the streams too)."""
    for b in svc.buckets if buckets is None else buckets:
        warm(decode_key(svc.params, svc.device, b, svc.gcfg.length, svc.gcfg,
                        svc.mcfg.gpt2.n_embd),
             lambda: svc.warmup(bucket=b, streams=False))


def service_facts(svc) -> Dict:
    """What a service decodes with: its device and the dtypes and decode
    step its ``auto`` settings resolved to (pinned from the largest
    bucket)."""
    from mmtg_tpu_torch.decoding import resolve_attn_impl

    g = svc.gcfg
    return {"device": device_name(svc.device), "weight_dtype": g.weight_dtype,
            "cache_dtype": g.cache_dtype,
            "attn_impl": resolve_attn_impl(g, svc.mcfg.gpt2.n_embd,
                                           batch_size=svc.buckets[-1])}


@contextlib.contextmanager
def scenario(label: str, svc, facts: Dict, observe: Optional[Observe] = None):
    """Around one measured scenario of a service: ``observe(label)`` is
    entered, and ``facts[label]`` gets the service's :func:`service_facts`,
    the windows it decoded in the scenario and their rate (a starved batcher
    shows as few windows a second beside the request rate), which is also
    printed as a ``# service`` comment line."""
    before = svc.stats()["batches"]
    t0 = time.perf_counter()
    with observe(label) if observe is not None else contextlib.nullcontext():
        yield
    wall = time.perf_counter() - t0
    windows = svc.stats()["batches"] - before
    facts[label] = dict(service_facts(svc), windows=windows, wall_s=wall,
                        windows_per_s=windows / wall)
    print(f"# service {label}: {json.dumps(facts[label])}", flush=True)


def emit(line: Dict) -> Dict:
    """Print one result line (JSON) and return it."""
    print(json.dumps(line), flush=True)
    return line
