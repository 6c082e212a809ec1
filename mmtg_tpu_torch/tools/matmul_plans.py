"""Time the batch-invariant product's candidate plans and forms on the card.

:func:`mmtg_tpu_torch.ops.matmul.plan` may not look at the row count M, so a
shape's plan has to serve every M the decode gives it. This tool runs, for
each of the model's dense product shapes (the decode step's four products a
layer, the LM head, the step embedding's two projector products; full width,
bf16), every tiled plan the kernel takes (column tiles of 64 or 32, K ranges
of 1 up to all of K's 64-value stages, at most 16 ranges) at each M (8, 64
and 512 by default; the B = 512 prefill gives 8192), beside ``F.linear`` on
the same inputs, as the launch runs it and in each form it can take (a
cluster of blocks, one a K range; one block walking the ranges in order with
64-row tiles; the same with 128-row tiles, 64-column plans only: the launch
picks by the number of tiles). Each candidate is first checked against the
plain version (within 2^-7 of the largest output), for a row alone (the
first and the last) bit-equal to the same row among M, and for its forms
bit-equal. The candidate with the least total time over the M is reported
beside the one ``plan`` picks. The batched small-K shapes (the prefill's
per-head ``probs @ v``, the beta mix) have one plan each; they are timed
beside ``torch.bmm``.

    python -m mmtg_tpu_torch.tools.matmul_plans [--rows 8,64,512]
        [--shapes qkv,mlp_proj] [--json out.json]

Device times are medians of single calls queued behind a sleep kernel (CUDA
events around the call alone). Prints one JSON line a shape and a last line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from mmtg_tpu_torch.ops import matmul as mm

D = 768
# name -> (Z or None, rows, K, N, bias, weight stored as [N, K]); rows None = M
SHAPES = {
    "qkv": (None, None, D, 3 * D, True, False),
    "attn_proj": (None, None, D, D, False, False),
    "mlp_fc": (None, None, D, 4 * D, True, False),
    "mlp_proj": (None, None, 4 * D, D, False, False),
    "lm_head": (None, None, D, 13317, False, True),
    "proj_in": (None, None, 2048, 512, True, False),
    "proj_out": (None, None, 512, D, True, False),
    "prefill_pv": (12, 16, 16, D // 12, False, False),
    "beta_mix": (5, 1, 3, 512, False, False),
}
TOL = 2.0 ** -7


def forms(pl):
    """The forms ``pl`` can run in (csrc/matmul.cu): 1 the cluster (with K
    ranges), 2 / 3 one block a tile of 64 / 128 rows (3: 64-column tiles)."""
    if pl.path == "small":
        return ()
    return ((1,) if len(pl.ranges) > 1 else ()) + (2,) + ((3,) if pl.bn == 64 else ())


def device_ms(fn, reps: int = 11, warmup: int = 2) -> float:
    """Median device time of one ``fn()`` call queued behind a sleep kernel."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def candidates(K: int, N: int):
    """Every tiled bf16 plan the kernel takes for ``[.., K] @ [K, N]``."""
    bk = 64
    nk = -(-K // bk)
    out = []
    for bn in mm.TILE_WIDTHS:
        for spr in sorted({-(-nk // r) for r in range(1, min(nk, mm.MAX_RANGES) + 1)}):
            out.append(mm.Plan("tiled", bn, bk, mm._ranges(K, bk, spr), min(spr, mm.MAX_SLOTS)))
    return out


def _inputs(name, M, gen, dev):
    Z, rows, K, N, has_bias, trans = SHAPES[name]
    if Z is not None:
        Z, rows = Z * M, rows
    lead = () if Z is None else (Z,)
    rows = M if rows is None else rows
    x = torch.randn(*lead, rows, K, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(*lead, *((N, K) if trans else (K, N)), generator=gen, device=dev)
         * 0.02).to(torch.bfloat16)
    w = w.transpose(-1, -2) if trans else w
    b = (torch.randn(N, generator=gen, device=dev) * 0.1).to(torch.bfloat16) if has_bias else None
    return x, w, b


def _check(name, x, w, b, pl):
    """Within TOL of the plain version; a row alone, and every form of the
    plan, give the same bits."""
    y = mm._launch(x, w, b, pl)
    ref = mm.matmul_plain(x, w, b)
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    first = mm._launch(x[:1], w[:1] if x.dim() == 3 else w, b, pl)[0]
    last = mm._launch(x[-1:], w[-1:] if x.dim() == 3 else w, b, pl)[0]
    other = [mm._launch(x, w, b, pl, f) for f in forms(pl)]
    if err > TOL * scale or not (torch.equal(first, y[0]) and torch.equal(last, y[-1])) or \
            not all(torch.equal(f, y) for f in other):
        raise RuntimeError(f"matmul_plans: {name} {pl}: max-abs {err:.3g} (largest "
                           f"{scale:.3g}), or a row alone or a form differs")


def sweep(rows, shapes=tuple(SHAPES), dev="cuda"):
    gen = torch.Generator(device=dev).manual_seed(0)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    results = []
    for name in shapes:
        Z, _, K, N, _, _ = SHAPES[name]
        chosen = mm.plan(K, N, torch.bfloat16, sm)
        cands = [chosen] if chosen.path == "small" else candidates(K, N)
        cands += [] if chosen in cands else [chosen]
        inputs = {M: _inputs(name, M, gen, dev) for M in rows}
        library = {}
        for M, (x, w, b) in inputs.items():
            if Z is None:
                library[M] = device_ms(lambda: torch.nn.functional.linear(x, w.T, b))
            else:
                library[M] = device_ms(lambda: torch.bmm(x, w))
        timed = []
        for pl in cands:
            ms, by_form = {}, {f: {} for f in forms(pl)}
            for M, (x, w, b) in inputs.items():
                _check(name, x, w, b, pl)
                ms[M] = device_ms(lambda: mm._launch(x, w, b, pl))
                for f in by_form:
                    by_form[f][M] = device_ms(lambda: mm._launch(x, w, b, pl, f))
            timed.append(dict(bn=pl.bn, spr=pl.spr, ranges=len(pl.ranges), slots=pl.slots,
                              blocks=-(-N // pl.bn) * len(pl.ranges), ms=ms,
                              total_ms=sum(ms.values()),
                              worst_ratio=max(ms[M] / library[M] for M in rows),
                              form_ms=by_form, chosen=pl == chosen))
        best = min(timed, key=lambda c: c["total_ms"])
        results.append(dict(shape=name, K=K, N=N, batched=Z is not None, library_ms=library,
                            best=best, chosen=next(c for c in timed if c["chosen"]),
                            candidates=timed))
    return results


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="8,64,512", help="the row counts M to time")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="the shapes to time")
    ap.add_argument("--json", default=None, help="write every candidate's times here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_plans: needs a CUDA device")
    rows = [int(r) for r in args.rows.split(",")]
    results = sweep(rows, args.shapes.split(","))
    for r in results:
        print(json.dumps({k: v for k, v in r.items() if k != "candidates"}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card(), shapes=results), f, indent=1)
    print(f"# card: {card()}")


if __name__ == "__main__":
    main()
