"""Streaming time-to-first-sentence benchmark of the port
(``tools/bench_stream.py`` of the JAX package).

What a streaming client feels at the service level
(``GenerationService.stream``, the generator ``/generate_stream`` wraps), at
the full MMTG size in bf16:

* **TTFS**: time from ``stream()`` to the first block on the host (the
  window's encoder, prefill and first 22-token sentence),
* the inter-block cadence (p50 gap between consecutive sentences),
* the total stream latency against the one-shot ``generate_sync`` p50 for
  the same request (the price of delivering block by block),
* token identity stream == batched for every measured (sample, seed), the
  serving contract (``serve.py``'s ``stream`` docstring): a mismatch exits
  non-zero.

With ``--concurrent N`` it measures N SIMULTANEOUS streaming clients
against one service instead: streams ride the window batcher, so they pack
into shared windows (``mean_batch`` > 1) while each client still gets
block-by-block delivery; ``--rounds`` rounds, the p50 round reported.

Warm-up: one one-shot decode a bucket the mode meets (the smallest in
sequential mode, every bucket in concurrent mode) that this process has not
warmed yet (``serve_common.warm_service``). The port compiles nothing, and a
chunked decode runs the one-shot decode's kernels at its shapes, so this
warms the streams too (the JAX tool warms both of its compiled programs).

Every block arrives as a host numpy array, so per-block timestamps are data
arrival times. Prints one JSON line (the JAX tool's keys) after a
``# service`` comment line. Runs on the CUDA card; ``--device cpu`` runs on
the CPU; ``--attn-impl`` is the port's addition; the JAX tool's compilation
cache has no counterpart.

    python -m mmtg_tpu_torch.tools.bench_stream [--streams 10] [--chunk 22]
    python -m mmtg_tpu_torch.tools.bench_stream --concurrent 64 --buckets 8,64
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional

import numpy as np

from mmtg_tpu_torch.tools.serve_common import (Observe, add_port_args,
                                               build_model, emit, make_payload,
                                               scenario, warm_service)


def _p50(xs):
    return float(np.percentile(np.asarray(xs, np.float64), 50))


def _bench_concurrent(svc, payloads, n, length, rounds=3):
    """N simultaneous stream() clients per round; returns aggregate tok/s
    over the round wall (first stream start → last block on host) plus
    per-client TTFS/total percentiles, p50 over rounds."""
    per_round = []
    for r in range(rounds):
        ttfs = [None] * n
        totals = [None] * n
        counts = [0] * n
        errors = []

        def client(i):
            t0 = time.perf_counter()
            try:
                for blk in svc.stream(payloads[i % len(payloads)],
                                      seed=10_000 * (r + 1) + i):
                    if ttfs[i] is None:
                        ttfs[i] = time.perf_counter() - t0
                    counts[i] += blk.size
            except Exception as e:  # noqa: BLE001 - re-raised after the join
                errors.append(e)
            totals[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"{len(errors)} streams failed") from errors[0]
        if any(c != length for c in counts):
            raise SystemExit(f"a stream did not deliver {length} tokens: "
                             f"{counts}")
        per_round.append({
            "tok_s": n * length / wall,
            "wall_s": wall,
            "ttfs_ms_p50": _p50([x * 1e3 for x in ttfs]),
            "total_ms_p50": _p50([x * 1e3 for x in totals]),
        })
    per_round.sort(key=lambda d: d["tok_s"])
    return per_round[len(per_round) // 2], per_round


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=10,
                    help="measured streams (after 1 warmup)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="tokens per block (default: frame length, 22)")
    ap.add_argument("--buckets", default="8", type=str,
                    help="service buckets (sized bucket 8 = latency tier; "
                         "auto weights/cache pin from the largest)")
    ap.add_argument("--concurrent", type=int, default=0,
                    help="measure N simultaneous streaming clients "
                         "(window-batched) instead of the sequential "
                         "TTFS loop; size --buckets to N")
    ap.add_argument("--rounds", type=int, default=3,
                    help="concurrent-mode rounds (reports the p50 round)")
    add_port_args(ap)
    return ap


def run(args, mcfg=None, dcfg=None, observe: Optional[Observe] = None,
        weights=None) -> dict:
    """One mode → ``{"lines": [line], "service": {label: facts}}``, label
    ``"streams"`` (sequential) or ``"concurrent"``; the arguments as
    :func:`mmtg_tpu_torch.tools.bench_serve.run`'s."""
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.serve import GenerationService

    device = resolve_device(args.device)
    params, const, mcfg, dcfg, gcfg = build_model(
        "auto", device, mcfg, dcfg, args.attn_impl, weights=weights)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    svc = GenerationService(params, const, mcfg, dcfg, gcfg,
                            buckets=buckets).start()
    out = {"lines": [], "service": {}}
    gcfg_line = {"weight_dtype": svc.gcfg.weight_dtype,
                 "cache_dtype": svc.gcfg.cache_dtype, "length": gcfg.length}
    try:
        payloads = [make_payload(i, dcfg, mcfg)
                    for i in range(max(args.streams, args.concurrent) + 1)]

        if args.concurrent:
            print(f"# warming up buckets {buckets} ...", flush=True)
            warm_service(svc)
            with scenario("concurrent", svc, out["service"], observe):
                mid, rounds = _bench_concurrent(
                    svc, payloads, args.concurrent, gcfg.length, args.rounds)
            st = svc.stats()
            out["lines"].append(emit({
                "metric": f"concurrent streaming throughput "
                          f"({args.concurrent} clients, window-batched)",
                "value": round(mid["tok_s"], 1),
                "unit": "tok/s",
                "vs_baseline": None,
                "detail": {
                    "concurrent": args.concurrent,
                    "rounds": [
                        {k: round(v, 1) for k, v in r.items()}
                        for r in rounds
                    ],
                    "ttfs_ms_p50": round(mid["ttfs_ms_p50"], 1),
                    "stream_total_ms_p50": round(mid["total_ms_p50"], 1),
                    "mean_batch": round(st["mean_batch"], 1),
                    "windows": st["batches"],
                    "buckets": list(buckets),
                    "gcfg": gcfg_line,
                },
            }))
            return out

        print(f"# warming up bucket {buckets[0]} ...", flush=True)
        warm_service(svc, buckets[:1])
        ttfs, gaps, totals, oneshot = [], [], [], []
        with scenario("streams", svc, out["service"], observe):
            for i in range(1, args.streams + 1):
                sample, seed = payloads[i], 1000 + i
                t0 = time.perf_counter()
                stamps, blocks = [], []
                for block in svc.stream(sample, seed, chunk=args.chunk):
                    stamps.append(time.perf_counter() - t0)  # block is on host
                    blocks.append(block)
                ttfs.append(stamps[0] * 1e3)
                gaps.extend(np.diff(stamps) * 1e3)
                totals.append(stamps[-1] * 1e3)

                t0 = time.perf_counter()
                tokens = svc.generate_sync(sample, seed)
                oneshot.append((time.perf_counter() - t0) * 1e3)
                streamed = np.concatenate(blocks)
                batched = np.asarray(tokens)[1:]  # drop the [#START#] seed
                if not np.array_equal(streamed, batched):
                    raise SystemExit(
                        f"stream != batched for seed {seed}: "
                        f"{int((streamed != batched).sum())} tokens differ"
                    )
    finally:
        svc.stop()

    n_blocks = -(-gcfg.length // (args.chunk or dcfg.sent_frame_length))
    out["lines"].append(emit({
        "metric": "streaming time-to-first-sentence (service level, "
                  "batch 1)",
        "value": round(_p50(ttfs), 1),
        "unit": "ms",
        "vs_baseline": None,
        "detail": {
            "streams": args.streams,
            "chunk_tokens": args.chunk or dcfg.sent_frame_length,
            "blocks_per_stream": n_blocks,
            "ttfs_ms_p50": round(_p50(ttfs), 1),
            "ttfs_ms_best": round(min(ttfs), 1),
            # chunk >= length => one block per stream, no gaps
            "inter_block_ms_p50": round(_p50(gaps), 1) if gaps else None,
            "stream_total_ms_p50": round(_p50(totals), 1),
            "oneshot_ms_p50": round(_p50(oneshot), 1),
            "stream_overhead_ms_p50": round(
                _p50(totals) - _p50(oneshot), 1
            ),
            "tokens_identical_to_batched": True,
            "gcfg": gcfg_line,
        },
    }))
    return out


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
