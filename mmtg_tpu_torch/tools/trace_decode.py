"""Trace a decode call of the port (``tools/trace_decode.py`` of the JAX
package) to attribute per-step device time.

Defaults: B=512, int8 cache, full-precision weights, the per-layer step
(``--attn-impl auto``); ``--attn-impl fused`` traces the whole-step kernel,
``--batch 1 --weight-dtype int8`` the latency regime. The model is the
full-size one in bf16 (the port's seeded init, seed 0); the WenLan table and
the prompt batch are the JAX tool's draws from ``np.random.default_rng(0)``,
in its order. One warm call, then one ``decoding.generate`` call inside
``utils/logging.maybe_profile`` (``<out>/trace_<pid>_<ns>.json``; on a card
the GPU timeline alone, as ``trace_train``), ending in a synchronize. Read
the trace per step with

    python -m mmtg_tpu_torch.tools.trace_train --parse-only --steps 220 --out <out>

``--attn-impl`` takes the port's names (``auto`` / ``kernel`` / ``fused``).
Runs on the CUDA card (``--device cpu`` to run without one).

    python -m mmtg_tpu_torch.tools.trace_decode [--batch 512] [--attn-impl fused]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--cache-dtype", default="int8",
                    choices=["model", "int8", "int4"])
    ap.add_argument("--weight-dtype", default="model",
                    choices=["auto", "model", "int8"])
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "kernel", "fused"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "trace_decode"))
    ap.add_argument("--device", default=None, type=str,
                    help="torch device (default: cuda; pass 'cpu' to run "
                         "without a GPU)")
    return ap


def run(args, mcfg=None, dcfg=None) -> dict:
    """Warm, then trace one call → ``{"tokens": the traced call's tokens,
    "gcfg": its GenerateConfig}``. ``mcfg`` / ``dcfg`` drive it at another
    model configuration (the call's length is ``dcfg.max_seq_length``, 220
    at the default one)."""
    from mmtg_tpu_torch.decoding import generate
    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.tools.fixed_cost_sweep import make_batch
    from mmtg_tpu_torch.tools.serve_common import build_model, make_table, sync
    from mmtg_tpu_torch.utils.logging import maybe_profile

    device = resolve_device(args.device)
    params, const, mcfg, dcfg, gcfg = build_model(
        args.cache_dtype, device, mcfg, dcfg, attn_impl=args.attn_impl)
    gcfg = dataclasses.replace(gcfg, weight_dtype=args.weight_dtype)
    rng = np.random.default_rng(0)
    make_table(mcfg, dcfg, rng)  # the table's draw comes first, as in JAX
    batch = make_batch(args.batch, mcfg, dcfg, rng, device,
                       const["wenlan_table"].dtype)
    key = prng.PRNGKey(1, device=device)

    generate(params, const, mcfg, dcfg, gcfg, batch, key).sum().item()  # warm
    with maybe_profile(args.out, host_ops=device.type == "cpu"):
        toks = generate(params, const, mcfg, dcfg, gcfg, batch, key)
        toks.sum().item()
        sync(device)
    print(f"traced b{args.batch} {args.weight_dtype}/{args.cache_dtype}/"
          f"{args.attn_impl} -> {args.out}")
    return {"tokens": toks, "gcfg": gcfg}


def main(argv=None) -> int:
    run(build_arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
