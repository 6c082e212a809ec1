"""Latency-regime decode bench of the port (``tools/bench_latency.py`` of the
JAX package): small-batch p50 against the modeled memory floor.

At serving batch sizes (1-32) every decode step reads all the weights for a
handful of rows, so a step's least cost is its weight read, and the lever
there is the weight bytes (``weight_dtype="int8"``, the ``auto`` choice for
B ≤ 32, ``decoding.resolve_weight_dtype``).

Measures the p50 whole-call latency (one batch of ``--length``-token
lyrics, full-size model in bf16) for each (batch, weight dtype) pair and
compares it with the memory floor: ``utils/roofline.decode_bytes_model``
with the dtypes the call resolved, over the card's memory rate
(``roofline.peak_hbm_gbps`` of its name; a card the table does not know
raises ``ValueError``), plus a per-call fixed cost F. F is the port's own:
``--fixed-cost-ms`` when given, else the fit of a
:mod:`~mmtg_tpu_torch.tools.fixed_cost_sweep` run in this process (at the
largest batch, lengths :data:`SWEEP_LENGTHS`). On ``--device cpu`` the
floor, F and ``x_of_floor`` are null: the CPU has no published rate.

Prints ONE JSON line (the JAX tool's keys; ``layer_unroll`` is null: the
port's eager layer loop has no unroll, and the JAX tool's ``--layer-unroll``
and compilation cache are dropped). ``--attn-impl`` takes the port's names
(``auto`` / ``kernel`` / ``fused``). Runs on the CUDA card.

    python -m mmtg_tpu_torch.tools.bench_latency [--batches 1,8,32] [--runs 5]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Optional

import numpy as np

from mmtg_tpu_torch.tools import fixed_cost_sweep
from mmtg_tpu_torch.tools.serve_common import (Observe, add_port_args,
                                               build_model, decode_key,
                                               device_name, emit, make_table,
                                               sync, warm)

# the fixed-cost sweep's lengths when F is not given: four, so that the fit
# of F + a L + b L^2/2 does not interpolate exactly
SWEEP_LENGTHS = "60,120,180,220"


def memory_floor_ms(total_bytes: float, kind: Optional[str],
                    fixed_cost_ms: Optional[float]) -> Optional[float]:
    """``total_bytes`` at the memory rate of the card named ``kind`` plus the
    fixed cost (a negative fit of it, the sweep's noise, counts as 0: a call
    costs at least its bytes); ``None`` on the CPU (``kind`` None). A card
    ``utils/roofline.py`` does not know raises ``ValueError``."""
    if kind is None:
        return None
    from mmtg_tpu_torch.utils.roofline import peak_hbm_gbps

    return (total_bytes / (peak_hbm_gbps(kind) * 1e9) * 1e3
            + max(fixed_cost_ms, 0.0))


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--weight-dtypes", default="model,int8")
    ap.add_argument("--cache-dtype", default="auto",
                    choices=["auto", "model", "int8", "int4"],
                    help="'auto' = what a flagless generate resolves to "
                         "(full precision at b1, int8 from b2 up)")
    ap.add_argument("--topk-impl", default="exact", choices=["exact", "approx"],
                    help="top-k sampling implementation ('approx' takes the "
                         "exact top-k in the port)")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--length", type=int, default=220)
    ap.add_argument("--fixed-cost-ms", type=float, default=None,
                    help="per-call fixed cost (encoder, prefill, cache "
                         "set-up, host dispatch) added to the memory floor; "
                         "default: fit by a fixed_cost_sweep run in this "
                         "process on the card")
    add_port_args(ap)
    return ap


def run(args, mcfg=None, dcfg=None, observe: Optional[Observe] = None,
        weights=None) -> dict:
    """The matrix → ``{"lines": [line], "calls": {label: timed calls}}``;
    ``observe(f"b{B} {wd}")`` is entered around each pair's timed calls.
    The other arguments as :func:`mmtg_tpu_torch.tools.bench_serve.run`'s."""
    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import (generate, resolve_attn_impl,
                                         resolve_cache_dtype,
                                         resolve_weight_dtype)
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.utils.roofline import (decode_bytes_model, dtype_name,
                                               peak_hbm_gbps)

    device = resolve_device(args.device)
    kind = None if device.type == "cpu" else device_name(device)
    peak = None if kind is None else peak_hbm_gbps(kind)  # before any timing
    params, const, mcfg, dcfg, _ = build_model(
        "auto", device, mcfg, dcfg, weights=weights)
    dtype = const["wenlan_table"].dtype
    batches = [int(b) for b in args.batches.split(",")]
    fixed_ms = args.fixed_cost_ms
    if kind is not None and fixed_ms is None:
        sweep = fixed_cost_sweep.build_arg_parser().parse_args([
            "--batch", str(max(batches)), "--lengths", SWEEP_LENGTHS,
            "--runs", str(args.runs), "--device", str(device),
            "--cache-dtype", resolve_cache_dtype(
                GenerateConfig(cache_dtype=args.cache_dtype), max(batches))])
        fixed_ms = fixed_cost_sweep.run(sweep, mcfg, dcfg,
                                        weights=(params, const))["lines"][0]["fixed_ms"]
    rng = np.random.default_rng(0)
    make_table(mcfg, dcfg, rng)  # the table's draw comes first, as in JAX

    key = prng.PRNGKey(1, device=device)
    rows, calls = [], {}
    for B in batches:
        batch = fixed_cost_sweep.make_batch(B, mcfg, dcfg, rng, device, dtype)
        for j, wd in enumerate(args.weight_dtypes.split(",")):
            gcfg = GenerateConfig(cache_dtype=args.cache_dtype,
                                  weight_dtype=wd, length=args.length,
                                  attn_impl=args.attn_impl,
                                  topk_impl=args.topk_impl)

            def call(k):
                toks = generate(params, const, mcfg, dcfg, gcfg, batch, k)
                toks.sum().item()  # waits for the device

            if j == 0:  # a warm-up call a batch size (the port compiles
                # nothing per shape: it meets the batch's shapes)
                warm(decode_key(params, device, B, args.length, gcfg,
                                mcfg.gpt2.n_embd), lambda: call(key))
                sync(device)
            times = []
            label = f"b{B} {wd}"
            with observe(label) if observe else contextlib.nullcontext():
                for i in range(args.runs):
                    t0 = time.perf_counter()
                    call(prng.fold_in(key, i))
                    times.append(time.perf_counter() - t0)
            calls[label] = args.runs
            times.sort()
            p50 = times[len(times) // 2]

            # 'auto' is a policy, not a byte width — resolve it the way
            # generate does before modeling the memory floor.
            wd_eff = resolve_weight_dtype(gcfg, B)
            cd_eff = resolve_cache_dtype(gcfg, B)
            m = decode_bytes_model(mcfg, dcfg, B, args.length,
                                   cache_dtype=cd_eff, weight_dtype=wd_eff,
                                   model_dtype=dtype_name(dtype))
            floor_ms = memory_floor_ms(m["total_bytes"], kind, fixed_ms)
            rows.append({
                "batch": B,
                "cache_dtype": cd_eff,
                "weight_dtype": wd_eff,
                "attn_impl": resolve_attn_impl(gcfg, mcfg.gpt2.n_embd,
                                               batch_size=B),
                "layer_unroll": None,
                "p50_ms": round(p50 * 1e3, 1),
                "best_ms": round(times[0] * 1e3, 1),
                "ms_per_token_per_row": round(p50 * 1e3 / args.length, 3),
                "tok_s": round(B * args.length / p50, 1),
                "memory_floor_ms": None if floor_ms is None else round(floor_ms, 1),
                "x_of_floor": None if floor_ms is None
                else round(p50 * 1e3 / floor_ms, 2),
            })
            floor = "no floor on the CPU" if floor_ms is None \
                else f"floor {floor_ms:.1f} ms"
            print(f"  b{B} {wd}: p50 {p50 * 1e3:.1f} ms ({floor})",
                  file=sys.stderr)

    b1_int8 = next((r for r in rows
                    if r["batch"] == 1 and r["weight_dtype"] == "int8"),
                   rows[0])
    line = emit({
        "metric": "p50 single-lyric decode latency (batch 1, int8 weights, "
                  f"{args.length} tokens)",
        "value": b1_int8["p50_ms"],
        "unit": "ms",
        "vs_baseline": None,
        "detail": {
            "rows": rows,
            "cache_dtype": args.cache_dtype,
            "length": args.length,
            "fixed_cost_ms": fixed_ms,
            "hbm_peak_gbps": peak,
            "floor_model": "roofline.decode_bytes_model / peak + measured "
                           "per-call fixed cost",
            "device": device_name(device),
        },
    })
    return {"lines": [line], "calls": calls}


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
