"""Split the wall of one ``decoding.generate`` call into fixed, per-step and
quadratic parts (``tools/fixed_cost_sweep.py`` of the JAX package), on the
port.

Decode tok/s is ``B * length / wall`` of one call, so every millisecond
outside the decode loop — encoder, prefill, cache allocation, the final
token transfer, the host's set-up — dilutes it exactly like a slow step.
Method: time generate at several lengths L. A step's cost grows linearly
with its position (attention reads the live prefix), so
``wall(L) = F + a*L + b*L^2/2``; a least-squares fit over the lengths
separates the fixed cost F from the marginal step cost. Give at least FOUR
lengths: with three the fit interpolates exactly and all the noise lands in
F.

Full-size model in bf16, the JAX tool's table and batch draws. Prints one
``L=...`` line per length and one JSON line (the JAX tool's keys). Runs on
the CUDA card; ``--device cpu`` runs on the CPU; the JAX tool's compilation
cache has no counterpart.

    python -m mmtg_tpu_torch.tools.fixed_cost_sweep [--batch 512] \\
        [--lengths 60,120,180,220]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np

from mmtg_tpu_torch.tools.serve_common import (Observe, add_port_args,
                                               build_model, decode_key, emit,
                                               make_table, sync, warm)


def make_batch(B: int, mcfg, dcfg, rng: np.random.Generator, device, dtype):
    """The JAX tools' synthetic prompt batch of ``B`` rows, drawn from
    ``rng`` after the table, as tensors on ``device``."""
    import torch

    P, E = dcfg.topic_prompt_length, dcfg.wenlan_emb_size
    ints = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731
    floats = lambda a: torch.from_numpy(a).to(device, dtype)  # noqa: E731
    return {
        "topic_ids": ints(rng.integers(103, 8000, (B, P))),
        "tpw_attention_mask": ints(np.ones((B, P))),
        "tpw_type_ids": ints(np.ones((B, P))),
        "topic_emb": floats(rng.standard_normal((B, E))),
        "img_embs": floats(rng.standard_normal((B, mcfg.seq_len, E))),
        "r_embs": floats(rng.standard_normal((B, mcfg.seq_len, E))),
    }


def fit(results: Dict[int, float], batch: int) -> dict:
    """Least squares of ``wall(L) = F + a L + b L^2/2`` over ``results``
    (length → p50 seconds) → the JAX tool's JSON line."""
    Ls = np.array(sorted(results))
    ys = np.array([results[L] for L in Ls])
    A = np.stack([np.ones_like(Ls), Ls, Ls**2 / 2], axis=1).astype(float)
    coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
    F, a, b = coef
    L = max(Ls)
    return {
        "fixed_ms": round(F * 1e3, 1),
        "per_step_ms_at_0": round(a * 1e3, 3),
        "per_step_ms_at_L": round((a + b * L) * 1e3, 3),
        "quad_ms_per_step2": round(b * 1e6, 4),
        "wall_ms_at_L": round(float(ys[-1]) * 1e3, 1),
        "fixed_share_pct": round(100 * F / float(ys[-1]), 1),
        "tok_s_at_L": round(batch * int(L) / float(ys[-1]), 1),
        "tok_s_if_fixed_free": round(batch * int(L) / float(ys[-1] - F), 1),
    }


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lengths", type=str, default="60,140,220")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cache-dtype", default="int8")
    add_port_args(ap, attn_impl=False)
    return ap


def run(args, mcfg=None, dcfg=None, observe: Optional[Observe] = None,
        weights=None) -> dict:
    """The sweep → ``{"lines": [fit line], "walls_s": {L: p50 seconds}}``;
    ``observe(f"L={L}")`` is entered around each length's timed calls. The
    other arguments as :func:`mmtg_tpu_torch.tools.bench_serve.run`'s."""
    from mmtg_tpu_torch.decoding import generate
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.ops import prng

    lengths = [int(x) for x in args.lengths.split(",")]
    device = resolve_device(args.device)
    params, const, mcfg, dcfg, gcfg = build_model(
        args.cache_dtype, device, mcfg, dcfg, weights=weights)
    rng = np.random.default_rng(0)
    make_table(mcfg, dcfg, rng)  # the table's draw comes first, as in JAX
    batch = make_batch(args.batch, mcfg, dcfg, rng, device,
                       const["wenlan_table"].dtype)
    key = prng.PRNGKey(1, device=device)

    def call(gcfg, k):
        toks = generate(params, const, mcfg, dcfg, gcfg, batch, k)
        toks.sum().item()  # waits for the device

    # one warm-up call: the port compiles nothing per length, and the
    # lengths share every shape but the cache's capacity
    warm(decode_key(params, device, args.batch, lengths[0], gcfg, mcfg.gpt2.n_embd),
         lambda: call(dataclasses.replace(gcfg, length=lengths[0]), key))
    sync(device)
    results = {}
    for L in lengths:
        gcfg_L = dataclasses.replace(gcfg, length=L)
        times = []
        with observe(f"L={L}") if observe else contextlib.nullcontext():
            for i in range(args.runs):
                t0 = time.perf_counter()
                call(gcfg_L, prng.fold_in(key, i))
                times.append(time.perf_counter() - t0)
        times.sort()
        results[L] = times[len(times) // 2]
        print(f"L={L}: p50 {results[L]*1e3:.1f} ms  "
              f"(times {[round(t*1e3) for t in times]})", flush=True)
    return {"lines": [emit(fit(results, args.batch))], "walls_s": results}


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
