#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mmtg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for
the numbers in PERF.md):

    python3 chip_smoke.py [--json results.json] [--profile] [--build-serial]

Phases, each printing one line (any failure raises and exits non-zero):
  1. build the CUDA kernels from mmtg_tpu_torch/csrc/ (nvcc, sm_90a) and
     print the build time and the card's name and power limit;
  2. every kernel against its plain PyTorch version on the card, at its
     main path's shapes: the decode-attention kernel through its seven
     wrappers (fp / int8 / int4 / merged caches, with and without the append:
     caches and scales bit-exact, ctx within the stated tolerance), the
     whole-step decode kernel (hidden state, appended codes and scales within
     the stated tolerance), the GRU kernel, and the train-attention
     kernels, forward + backward (ctx, dqkv, dqb at rate 0 and rate 0.1 with
     the same dropout hash, f32 and bf16): mha_train_packed at B=8 and B=64,
     T=256; mha_train_packed_seg at 32 rows of 512 with the segment ids of a
     real PackedBatcher batch; mha_train (head-major slab, heads padded
     64 -> 128) at B=64, T=256. Each is timed (CUDA events, median of single calls queued behind a sleep
     kernel so host overhead is excluded) beside its plain version and one
     PyTorch library call used nowhere in the port, and its bound (the
     larger of bytes / 3.35 TB/s and operations / peak) is computed; then
     the same for every decode wrapper (bf16), the GRU and the whole-step
     kernel (both types) at B=1 (the p50 path) and B=512, the whole-step
     kernel's ptxas line and launch plan beside its times;
  3. the generation path, decoding.generate, at the full model width
     (12-layer 768-d GPT-2, vocab 13317, 2048-d WenLan, random seeded
     weights) in bf16: B=64 with the int8 cache, then B=8 and B=1 with the
     bf16 cache; the kernel launch counters prove the kernels ran; the B=1
     call's median wall over 5 calls is the p50 latency;
  4. teacher-forced logits through the kernels vs through the plain
     versions, full width, f32: fp, int8, int4 and merged caches, and the
     whole-step kernel;
  5. the generate CLI on a synthetic .pth checkpoint;
  6. the train path, train.make_train_step, at full width: bf16 compute /
     f32 masters, B=64, dropout on, remat on, 1 warm-up + 5 timed steps on
     one repeated batch (loss finite and falling, launch counts asserted),
     then B=8 in f32 without dropout: loss and every gradient leaf through
     the kernels vs through the plain attention;
  7. the train CLI (default device: the card) on synthetic records, depth
     cut to 2 layers: an epoch, a checkpoint, a resumed second epoch; then the
     generate CLI (default device) on the --save_path it wrote;
  8. the packed-sequence train path (--pack_sequences) at full width:
     make_train_step on PackedBatcher batches, 32 rows of 512, bf16 compute /
     f32 masters, dropout on, remat on, 1 warm-up + 5 timed steps (launch
     counts of mha_train_packed_seg asserted, none of mha_train_packed), then
     4 rows in f32: loss and gradients, kernel path vs plain path; then one
     bf16 and one f32 step on 16 rows of 1024 (--pack_row_len 1024);
  9. the unpacked train step through the head-major kernel
     (attn_impl="kernel_padded") at B=64, 1 + 3 steps, then B=8 in f32: loss
     and gradients vs the standard-slab path;
 10. the train CLI with --pack_sequences (2 layers, --resume) and the
     pretrain CLI (2 layers), whose file the train CLI's --gpt2_ckpt loads.
 11. the read-only decode kernels as oracles: append, then read the cache
     just written with the read-only kernel of its kind: the same context;
 12. decoding.generate through the serving decode paths at full width, B=64,
     bf16: int4 cache, merged k||v cache, the whole-step kernel
     (attn_impl="fused"), beside the int8 per-layer path; launch counts
     asserted (2640 per-layer launches, or 220 of the whole-step kernel);
 13. generate_stream with per-row seeds at B=64 vs generate with the same
     seeds (equal token for token), and the time to the first block;
 14. the service as `python -m mmtg_tpu_torch.serve` builds it (default
     device: the card), full width: concurrent requests through submit, one
     streamed over HTTP on a local port, /reload, a clean stop; every
     response held against generate with the same seeds.
 15. the LSTM, RNN and TRM encoder channels at full width: for each,
     decoding.generate at B=64 (bf16, int8 cache: 2640 launches of the
     int8-append kernel and none of the GRU kernel), teacher-forced f32
     logits through the kernels vs the plain versions, and 1 + 2 bf16 train
     steps at B=64 (dropout, remat; mha_train_packed's counts asserted);
 16. mmtg_forward_infer (the no-cache inference forward) at full width, f32,
     B=8, both type-id schemes: mha_train_packed's forward vs
     attn_impl="plain", and its logits at the target positions vs the
     cached decode's teacher-forced logits;
 17. the English variant (CLIP 512, vocab 50257, n_positions 1024): 1 + 3
     bf16 train steps at B=64, generate at B=64 (int8 cache, the GRU kernel
     at input width 512) and B=1 (bf16 cache); then at depth 2 the train CLI
     bootstrapped from a model.safetensors snapshot with --profile_dir, the
     generate CLI on its save path, eval on the output (BPE vocab, records
     and table made by the phase; the native BPE encoder asserted loaded);
 18. the REPL (mmtg_tpu_torch.predict, default device) on phase 7's save path
     with the swap probe, two indices; MMTGDataset's token columns through
     the native row packer vs the Python framing, and both framings' rate
     (rows a second) over 4096 rows.
(Phases 11-14 run after phase 4, phases 15-18 after phase 10.) It then prints
the kernels' JSON line and, last, the device JSON line.
--profile adds a torch.profiler kernel-time split of one B=64 train step
and of one packed train step;
--build-serial also times one nvcc process over all sources beside the
parallel build; --kernels-only stops after phase 2 (to time another
checkout's kernels with this script's measurements). Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

L, B_ATT, T_CAP, D, H = 12, 64, 256, 768, 12
POSITIONS = (0, 15, 16, 127, 128, 235)
TIMED_POSITION = 235  # the last decode step: the longest live prefix
GRU_SHAPE = dict(T=5, B=64, I=2048, H=512)
OTHER_BATCHES = (1, 512)  # phase 2 beside B=64: the p50 path and the widest batch
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (attention, GRU)
LENGTH = 220
P50_CALLS = 5  # B=1 generate calls whose median wall is the p50 latency
DEVICE = "cuda"
# published H100 SXM peaks the bounds are reckoned against
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TRAIN_T, TRAIN_HD = 256, 64  # 15 + 221 = 236 tokens padded to 256
TRAIN_BATCHES = (8, 64)  # the kernel-vs-plain check; the train step runs 64
# mha_train_packed vs its plain version: (ctx, dqkv, dqb). ctx and dqkv are
# max-abs on values of order 1: f32 differs by summation order only, bf16 by
# one rounding of the working type (the bf16 forward sweeps the key tiles
# with an online softmax and rounds the dropped-out UN-NORMALISED
# probabilities before the product with v, where the plain version rounds
# the normalised ones: ctx is within one bf16 step, no longer bit-equal).
# dqb sums B*T rows (its entries reach the hundreds), in another order and
# by atomic adds, so it is checked relative to its largest entry.
TRAIN_TOL = {"float32": (1e-5, 1e-5, 1e-4), "bfloat16": (2e-2, 4e-2, 2e-2)}
PACK_ROWS, PACK_T, PACK_SLOTS = 32, 512, 8  # 32 x 512 = the tokens of B=64 x 256
# mha_train_packed_seg at T=512: dk and dv sum over up to 512 queries, so
# dqkv's entries pass 8, where one bf16 rounding is 0.0625 (the largest |dqkv|
# is printed beside the error); f32 as above.
SEG_TOL = {"float32": TRAIN_TOL["float32"], "bfloat16": (2e-2, 8e-2, 2e-2)}
LONG_ROWS, LONG_T = 16, 1024  # packed rows of n_positions: the same tokens a step


def model_configs():
    """The repo's model: 12-layer / 12-head / 768-d GPT-2, vocab 13317,
    2048-d WenLan inputs, 5 experience steps."""
    from mmtg_tpu_torch.configs import DataConfig, ModelConfig

    return ModelConfig(), DataConfig()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, dname: str) -> dict:
    """The least time the card could take: each input read and each output
    written once at the memory rate, the operations at the peak rate of
    their type; the larger of the two."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, operations=ops)


def device_ms(fn, reps: int = 25, warmup: int = 5, between=None) -> float:
    """Median device time of one ``fn()`` call: each call is queued behind a
    sleep kernel, so the events bracket GPU work only."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for r in range(reps):
        if between is not None:
            between(r)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------


def phase_build(out, serial=False):
    from mmtg_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    if serial:
        # the same sources and flags through ONE nvcc process, for comparison
        # with the build above (one process per source, started together)
        with tempfile.TemporaryDirectory(prefix="mmtg_serial_build_") as tmp:
            t0 = time.perf_counter()
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                            os.path.join(tmp, "serial.so"), *_build.sources()],
                           capture_output=True, text=True, check=True)
            out["build_serial_s"] = time.perf_counter() - t0
        print(f"build, one nvcc process over all sources: "
              f"{out['build_serial_s']:.1f} s (in parallel: {secs:.1f} s)")
    with open(_build.library_path() + ".log") as f:
        regs = [ln.strip() for ln in f if "Used" in ln]
    print(f"phase 1 build: ok, {secs:.1f} s, {len(_build.sources())} sources "
          f"-> {os.path.relpath(_build.library_path())}; ptxas: "
          + " | ".join(regs))
    print(f"gpu: {gpu_line()}")
    out["build_s"] = secs
    out["ptxas"] = regs


# (wrapper, cache kind, append stage) of the seven decode-attention wrappers:
# one kernel, csrc/decode_attention.cu
DECODE_WRAPPERS = (
    ("decode_attention_int8_append", "int8", True),
    ("decode_attention_fp_append", "fp", True),
    ("decode_attention_int4_append", "int4", True),
    ("decode_attention_int8_append_merged", "merged", True),
    ("decode_attention", "fp", False),
    ("decode_attention_int8", "int8", False),
    ("decode_attention_int4", "int4", False),
)


def _attention_case(dtype, kind, gen, B=B_ATT):
    """q, k_new, v_new, a key mask with holes, and a cache of ``kind`` (fp /
    int8 / int4 / merged) filled everywhere: (q, k_new, v_new, mask, caches,
    scales) with caches = [k, v] or [kv]."""
    import torch

    dev = DEVICE
    q, k_new, v_new = (torch.randn(B, D, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
    mask = torch.randint(0, 2, (B, T_CAP), generator=gen, device=dev,
                         dtype=torch.int32)
    mask[:, 0] = 1
    if kind == "fp":
        return q, k_new, v_new, mask, [
            torch.randn(L, B, T_CAP, D, generator=gen, device=dev).to(dtype)
            for _ in range(2)], []
    row = {"int8": D, "int4": D // 2, "merged": 2 * D}[kind]
    caches = [torch.randint(-127, 128, (L, B, T_CAP, row), generator=gen,
                            device=dev, dtype=torch.int8)
              for _ in range(1 if kind == "merged" else 2)]
    scales = [torch.rand(L, B, T_CAP, generator=gen, device=dev) * 0.02 + 0.005
              for _ in range(2)]
    return q, k_new, v_new, mask, caches, scales


def _decode_calls(da, name, kind, append, q, k_new, v_new, mask):
    """(kernel call, plain call) of one wrapper, each taking (caches, scales,
    position, layer)."""
    kernel = getattr(da, name)
    new = (k_new, v_new) if append else ()

    def run_kernel(caches, scales, pos, layer):
        return kernel(q, *new, *caches, *scales, mask, pos, layer, n_head=H)

    def run_plain(caches, scales, pos, layer):
        if append:
            return da.decode_attention_append_plain(
                q, k_new, v_new, caches[0], None if kind == "merged" else caches[1],
                mask, pos, layer, H, *scales)
        return da.decode_attention_plain(q, *caches, mask, pos, layer, H, *scales)

    return run_kernel, run_plain


# decode_block_fused vs its plain version (the per-layer loop). The kernel's
# products sum in another order than torch.matmul, so a k/v entry differs in
# its last bits (f32) or by one rounding of the stream type (bf16). In layer
# 0, whose k/v depend on LN1 and the QKV product alone, an entry on a rounding
# boundary is appended as a code 1 apart (bf16: up to 2, the entry's and the
# row maximum's rounding) and a scale differs by the summation order (1e-5)
# or one bf16 step (1e-2). A v code 1 apart moves a context entry by one
# quantization step, 1/127 of the row's largest entry, times that slot's
# probability (position 0: one live slot, probability 1). So h is held to
# 5e-3 of its largest entry in f32 (the JAX package's tests hold the TPU
# kernel's logits to 5e-3 for the same reason) and 4e-2 in bf16 (12 layers of
# 2^-8 steps); the later layers' scales inherit h's difference and are held as
# h is, their codes to 1 + 127 x that (2 in f32, 6 in bf16).
FUSED_TOL = {
    "float32": dict(h_rel=5e-3, codes0=1, codes=2, scale0_rel=1e-5, scale_rel=5e-3),
    "bfloat16": dict(h_rel=4e-2, codes0=2, codes=6, scale0_rel=1e-2, scale_rel=4e-2)}

# f32 logits of the whole engine over 60 teacher-forced steps at full width,
# max-abs. Kernels against the plain versions per cache form, and the
# whole-step kernel against the per-layer kernels. A quantized code on a
# rounding boundary moves the logits, most with int4's 15 levels.
TEACHER_FORCED_TOL = {"model": 1e-3, "int8": 2e-3, "merged": 2e-3, "int4": 5e-3,
                      "fused": 2e-3, "fused_vs_per_layer": 2e-3}
# mmtg_forward_infer's logits through mha_train_packed's f32 forward vs its
# plain version: the attention sums in another order, nothing else differs
INFER_TOL = 1e-4


def _fused_weight_bytes_and_ops(p):
    from mmtg_tpu_torch.ops.decode_megakernel import PARAM_KEYS

    nbytes = sum(p[k].numel() * p[k].element_size() for k in PARAM_KEYS)
    macs = sum(p[k].numel() for k in ("attn_w", "attn_proj_w", "mlp_fc_w", "mlp_proj_w"))
    return nbytes, macs


def _ptxas_of(name):
    """The ptxas lines (registers, shared memory, spills) of the kernels whose
    mangled names hold ``name``, from the build log."""
    from mmtg_tpu_torch.kernels import _build

    lines, current = [], ""
    with open(_build.library_path() + ".log") as f:
        for ln in f:
            if "Compiling entry function" in ln or "Function properties for" in ln:
                current = ln
            elif name in current and ("Used" in ln or "spill" in ln):
                lines.append(ln.strip())
    return lines


def phase_block_fused(results, gen, B=B_ATT):
    """decode_block_fused (all 12 layers of one step in one launch) vs its plain
    version at the full model width, batch ``B``, T=256, positions POSITIONS;
    timed at TIMED_POSITION beside the plain version and the port's own
    per-layer step at the same B. Stored under ("decode_block_fused", dtype)
    at B_ATT, else with "B<B>"."""
    import torch

    from mmtg_tpu_torch.models import gpt2
    from mmtg_tpu_torch.ops import decode_megakernel as mk
    from mmtg_tpu_torch.params import init_gpt2_params

    mcfg, _ = model_configs()
    cfg = mcfg.gpt2
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = FUSED_TOL[dname]
        p = init_gpt2_params(cfg, seed=4, dtype=dtype, device=DEVICE)["h"]
        # biases and gains off their init values, so that each one matters
        p = {k: (v + 0.05 * torch.randn(v.shape, generator=gen, device=DEVICE).to(dtype)
                 if v.dim() == 2 else v) for k, v in p.items()}
        h = (torch.randn(B, D, generator=gen, device=DEVICE) * 0.5).to(dtype)
        _, _, _, mask, base_c, base_s = _attention_case(dtype, "int8", gen, B)
        base = base_c + base_s
        errs = {k: 0.0 for k in tol}
        by_pos = {}
        for pos in POSITIONS:
            kc = [c.clone() for c in base]
            pc = [c.clone() for c in base]
            got = mk.decode_block_fused(h, p, *kc, mask, pos, n_head=H,
                                        eps=cfg.layer_norm_epsilon)
            ref = mk.decode_block_fused_plain(h, p, *pc, mask, pos, n_head=H,
                                              eps=cfg.layer_norm_epsilon)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"decode_block_fused {dname} B={B} pos {pos}: h not finite")
            e = dict(h_rel=((got.float() - ref.float()).abs().max()
                            / ref.float().abs().max()).item(),
                     codes0=0.0, codes=0.0, scale0_rel=0.0, scale_rel=0.0)
            for a, b, orig in zip(kc[:2], pc[:2], base[:2]):
                d = (a[:, :, pos].int() - b[:, :, pos].int()).abs()
                e["codes"] = max(e["codes"], d.max().item())
                e["codes0"] = max(e["codes0"], d[0].max().item())
            for a, b, orig in zip(kc[2:], pc[2:], base[2:]):
                rel = (a[:, :, pos] - b[:, :, pos]).abs() / b[:, :, pos]
                e["scale_rel"] = max(e["scale_rel"], rel.max().item())
                e["scale0_rel"] = max(e["scale0_rel"], rel[0].max().item())
            for a, orig in zip(kc, base):  # nothing but slot `position` written
                a[:, :, pos] = orig[:, :, pos]
                check(torch.equal(a, orig), f"decode_block_fused {dname} B={B} pos "
                      f"{pos}: a slot other than `position` was written")
            by_pos[pos] = e
            errs = {k: max(errs[k], e[k]) for k in errs}
            del kc, pc
        summary = (f"h {errs['h_rel']:.3g} of its largest entry (by position: "
                   + ", ".join(f"{k}: {v['h_rel']:.2g}" for k, v in by_pos.items())
                   + f"), codes within {errs['codes']:.0f} (layer 0: {errs['codes0']:.0f}),"
                   f" scales {errs['scale_rel']:.3g} (layer 0: {errs['scale0_rel']:.3g})")
        for k in tol:
            check(errs[k] <= tol[k], f"decode_block_fused {dname} B={B}: {k} "
                  f"{errs[k]:.3g} > {tol[k]}; {summary}")
        errs["by_position"] = by_pos
        state = [c.clone() for c in base]
        cache = gpt2.KVCache(*state)
        args = (h, p, *state, mask, TIMED_POSITION)
        ms = device_ms(lambda: mk.decode_block_fused(
            *args, n_head=H, eps=cfg.layer_norm_epsilon), reps=11, warmup=2)
        plain_ms = device_ms(lambda: mk.decode_block_fused_plain(
            *args, n_head=H, eps=cfg.layer_norm_epsilon), reps=11, warmup=2)
        # no one PyTorch call computes a decode step; the yardstick is the
        # port's own per-layer step: cuBLAS products, eager elementwise ops
        # and the per-layer decode-attention kernel, 12 layers
        per_layer_ms = device_ms(lambda: gpt2._decode_layers(
            p, cfg, cache, h, TIMED_POSITION, mask, True, "int8", H), reps=11, warmup=2)
        n_live = int((mask[:, :TIMED_POSITION + 1] != 0).sum())
        w_bytes, macs = _fused_weight_bytes_and_ops(p)
        e = h.element_size()
        nbytes = (w_bytes + 2 * B * D * e                     # weights, h in and out
                  + L * (2 * n_live * D + 2 * 4 * n_live      # live k/v rows, scales
                         + 2 * B * D + 2 * 4 * B)             # appended rows, scales
                  + 4 * B * (TIMED_POSITION + 1))             # mask
        ops = 2.0 * B * macs + L * 4.0 * n_live * D
        key = ("decode_block_fused", dname) if B == B_ATT else ("decode_block_fused", dname, f"B{B}")
        pl = mk.plan(B, D, L, T_CAP, H, dtype,
                     torch.cuda.get_device_properties(0).multi_processor_count)
        grid = dict(grid=pl.grid, blocks_per_sm=pl.blocks_per_sm, smem=pl.smem,
                    products={q.name: (q.nt, q.splits) for q in pl.products})
        results[key] = dict(
            max_abs_err=errs["h_rel"], errs=errs, ms=ms, plain_ms=plain_ms,
            library_ms=None, per_layer_step_ms=per_layer_ms, launch_plan=grid,
            **bound(nbytes, ops, dname))
        lines.append(
            f"decode_block_fused[{dname} B={B}] {summary}; kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms per-layer step (the port's own: cuBLAS "
            f"+ eager ops + attention kernel) {per_layer_ms:.4f} ms bound "
            f"{results[key]['bound_ms']:.4f} ms; grid {grid}")
        del p, state, cache, base, base_c, base_s
        torch.cuda.empty_cache()
    return lines


def _decode_vs_plain(results, da, name, kind, append, dtype, B, gen):
    """One decode-attention wrapper (the kernel) vs its plain version at
    batch ``B``: ctx within TOL and the cache and scales bit for bit at every
    position of POSITIONS; then device times of the kernel, the plain version
    and (fp cache) one SDPA call at TIMED_POSITION, and the bound. Stores the
    result under (name, dtype) at B_ATT, else (name, dtype, "B<B>")."""
    import torch

    dname = str(dtype).split(".")[1]
    q, k_new, v_new, mask, base_c, base_s = _attention_case(dtype, kind, gen, B)
    run_kernel, run_plain = _decode_calls(da, name, kind, append, q, k_new,
                                          v_new, mask)
    err = 0.0
    for pos in POSITIONS:
        layer = pos % L
        kc = [c.clone() for c in base_c + base_s]
        pc = [c.clone() for c in base_c + base_s]
        n = len(base_c)
        ctx_k = run_kernel(kc[:n], kc[n:], pos, layer)
        ctx_p = run_plain(pc[:n], pc[n:], pos, layer)
        torch.cuda.synchronize()
        # appended bytes and scales bit for bit (read-only: untouched)
        for a, b, orig in zip(kc, pc, base_c + base_s):
            check(torch.equal(a, b), f"{name} {dname} B={B} pos {pos}: a cache "
                  "or scale tensor differs from the plain version")
            check(append or torch.equal(a, orig),
                  f"{name} {dname} B={B} pos {pos}: a read-only call wrote")
        e = (ctx_k.float() - ctx_p.float()).abs().max().item()
        check(e <= TOL[dname][0], f"{name} {dname} B={B} pos {pos}: ctx "
              f"max-abs {e:.3g} > {TOL[dname][0]}")
        err = max(err, e)
        del kc, pc
    caches, scales = [c.clone() for c in base_c], [c.clone() for c in base_s]
    state = {"layer": 0}

    def rotate(r):  # a different layer per call: the cache is cold
        state["layer"] = r % L

    ms = device_ms(lambda: run_kernel(caches, scales, TIMED_POSITION,
                                      state["layer"]), between=rotate)
    plain_ms = device_ms(lambda: run_plain(caches, scales, TIMED_POSITION,
                                           state["layer"]), between=rotate)
    library_ms = None
    if kind == "fp":
        # the library yardstick: (write the row, then) one SDPA call
        # over the live prefix (no PyTorch call reads a quantized cache)
        W = TIMED_POSITION + 1
        slot = torch.tensor([TIMED_POSITION], device=DEVICE)
        live = (mask[:, :W] != 0)[:, None, None, :]

        def run_library():
            kc, vc = caches[0][state["layer"]], caches[1][state["layer"]]
            if append:
                kc.index_copy_(1, slot, k_new[:, None])
                vc.index_copy_(1, slot, v_new[:, None])
            heads = lambda t: t[:, :W].view(B, W, H, D // H).transpose(1, 2)  # noqa: E731
            return torch.nn.functional.scaled_dot_product_attention(
                q.view(B, H, 1, D // H), heads(kc), heads(vc),
                attn_mask=live)

        library_ms = device_ms(run_library, between=rotate)
    # the bound counts what this mask needs: live slots only, each
    # stored k and v row once (D, or D/2 bytes for int4)
    n_live = int((mask[:, :TIMED_POSITION + 1] != 0).sum())
    e, c = q.element_size(), caches[0].element_size()
    row = D // 2 if kind == "int4" else D
    nbytes = (B * D * e + 2 * n_live * row * c   # q, live k/v rows
              + 4 * B * (TIMED_POSITION + 1) + B * D * e  # mask, ctx
              + (2 * 4 * n_live if kind != "fp" else 0))  # live scales
    if append:  # k_new / v_new in, the appended rows (and scales) out
        nbytes += 2 * B * D * e + 2 * B * row * c
        nbytes += 2 * 4 * B if kind != "fp" else 0
    key = (name, dname) if B == B_ATT else (name, dname, f"B{B}")
    results[key] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(nbytes, 4.0 * n_live * D, dname))
    del base_c, base_s, caches, scales
    torch.cuda.empty_cache()
    return (f"{name}[{dname} B={B}] err {err:.3g} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms library "
            f"{'none' if library_ms is None else format(library_ms, '.4f') + ' ms'}"
            f" bound {results[key]['bound_ms']:.4f} ms")


def _gru_vs_plain(results, fg, dtype, B, gen):
    """fused_gru (the kernel) vs its plain version at batch ``B``; device
    times of the kernel, the plain version and cuDNN's GRU, and the bound.
    Stored under ("fused_gru", dtype) at GRU_SHAPE's B, else with "B<B>"."""
    import torch

    s = dict(GRU_SHAPE, B=B)
    dname = str(dtype).split(".")[1]
    x = torch.randn(s["T"], s["B"], s["I"], generator=gen, device=DEVICE).to(dtype)
    w_ih = (torch.randn(s["I"], 3 * s["H"], generator=gen, device=DEVICE)
            * (2.0 / (3 * s["H"] + s["I"])) ** 0.5).to(dtype)
    w_hh = torch.linalg.qr(torch.randn(3 * s["H"], s["H"], generator=gen,
                                       device=DEVICE))[0].T.contiguous().to(dtype)
    b_ih, b_hh = ((torch.rand(3 * s["H"], generator=gen, device=DEVICE) * 2 - 1)
                  .mul(s["H"] ** -0.5).to(dtype) for _ in range(2))
    args = (x, w_ih, w_hh, b_ih, b_hh)
    before = fg.fused_gru.launches
    y_k = fg.fused_gru(*args)
    y_p = fg.fused_gru_plain(*args)
    torch.cuda.synchronize()
    check(fg.fused_gru.launches == before + 1, "fused_gru: not one launch a call")
    check(y_k.shape == y_p.shape and y_k.dtype == dtype, "fused_gru shape/dtype")
    e = (y_k.float() - y_p.float()).abs().max().item()
    check(e <= TOL[dname][1], f"fused_gru {dname} B={B}: max-abs {e:.3g} > "
          f"{TOL[dname][1]}")
    ms = device_ms(lambda: fg.fused_gru(*args))
    plain_ms = device_ms(lambda: fg.fused_gru_plain(*args))
    gru = torch.nn.GRU(s["I"], s["H"], device=DEVICE, dtype=dtype)
    with torch.no_grad():  # the library yardstick: cuDNN's GRU
        gru.weight_ih_l0.copy_(w_ih.T)
        gru.weight_hh_l0.copy_(w_hh.T)
        gru.bias_ih_l0.copy_(b_ih)
        gru.bias_hh_l0.copy_(b_hh)
        library_ms = device_ms(lambda: gru(x))
    n_elems = sum(t.numel() for t in args) + y_k.numel()
    ops = 2.0 * s["T"] * s["B"] * 3 * s["H"] * (s["I"] + s["H"])
    key = ("fused_gru", dname) if B == GRU_SHAPE["B"] else ("fused_gru", dname, f"B{B}")
    results[key] = dict(
        max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(n_elems * x.element_size(), ops, dname))
    return (f"fused_gru[{dname} B={B}] err {e:.3g} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{results[key]['bound_ms']:.4f} ms")


def phase_kernels(out):
    import torch

    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {}
    lines = []
    for name, kind, append in DECODE_WRAPPERS:
        for dtype in (torch.float32, torch.bfloat16):
            lines.append(_decode_vs_plain(results, da, name, kind, append, dtype, B_ATT, gen))
    lines += phase_block_fused(results, gen)

    for dtype in (torch.float32, torch.bfloat16):
        lines.append(_gru_vs_plain(results, fg, dtype, GRU_SHAPE["B"], gen))
    print("phase 2 kernels vs plain: ok; " + "; ".join(lines))
    # the p50 path (B=1) and the widest batch (B=512), bf16: every decode
    # wrapper, and the GRU in both types. Their own generator: the train
    # attention below keeps the inputs its tolerances were set on.
    other, gen_other = [], torch.Generator(device=DEVICE).manual_seed(1)
    for B in OTHER_BATCHES:
        for name, kind, append in DECODE_WRAPPERS:
            other.append(_decode_vs_plain(results, da, name, kind, append,
                                          torch.bfloat16, B, gen_other))
        for dtype in (torch.float32, torch.bfloat16):
            other.append(_gru_vs_plain(results, fg, dtype, B, gen_other))
        other += phase_block_fused(results, gen_other, B)
    print("phase 2 kernels vs plain at B=1 and B=512: ok; " + "; ".join(other))
    print("phase 2 decode_block_fused ptxas: " + " | ".join(_ptxas_of("decode_block_fused")))
    for name, lines in phase_train_attention(results, gen).items():
        print(f"phase 2 {name} vs plain: ok; " + "; ".join(lines))
    print(f"phase 2 mha_train_packed_seg: the batch's segment ids let "
          f"{results['seg_pairs_share']:.3f} of the causal pairs attend")
    out["kernels_vs_plain"] = {
        f"{k[0]}[{','.join(str(x) for x in k[1:])}]": v for k, v in results.items()
        if isinstance(k, tuple)}
    return results


def _sdpa_mask(bias, T):
    """The kernel's causal + key-padding mask as SDPA's boolean mask."""
    import torch

    causal = torch.ones(T, T, dtype=torch.bool, device=bias.device).tril()
    return causal[None, None] & (bias == 0)[:, None, None, :]


def _key_bias(B, T):
    import torch

    from mmtg_tpu_torch.ops import train_attention as ta

    bias = torch.zeros(B, T, device=DEVICE)
    bias[:, 236:] = ta.NEG_INF  # the pad to 256
    bias[::3, 200:236] = ta.NEG_INF  # short rows
    return bias


def packed_batches(dcfg, n_samples, rows, seed, emb_size=None, row_len=PACK_T):
    """Packed batches as the trainer makes them: synthetic framed samples
    with sentence lengths clip(normal(12, 4), 2, 20), next-fit packed into
    rows of ``row_len`` with at most PACK_SLOTS samples each. Returns (the
    packer, the list of full numpy batches)."""
    import numpy as np

    from mmtg_tpu_torch.pack import PackedBatcher, synthetic_framed_cols

    rng = np.random.default_rng(seed)
    lens = np.clip(rng.normal(12.0, 4.0, (n_samples, 10)), 2, 20).astype(np.int64)
    cols = synthetic_framed_cols(rng, dcfg, lens, emb_size=emb_size)
    cols["rating"][:] = 5.0  # stage 3 keeps all, y = 1
    pb = PackedBatcher(cols, dcfg, row_len=row_len, max_slots=PACK_SLOTS)
    full = [b for b in pb.batches(rows, shuffle=True, rng=np.random.default_rng(seed + 1))
            if b["slot_valid"].any(axis=1).all()]
    check(bool(full), "packing produced no full batch")
    return pb, full


def _attention_vs_plain(results, name, fn, plain, dtype, B, qkv, qb, mask, co, scale,
                        sdpa_inputs, nbytes, pairs, hd_ops, tols=TRAIN_TOL):
    """One train-attention function (kernels) vs its plain version on the
    same inputs: ctx, dqkv, dqb at rate 0 and 0.1; then device times of the
    kernels, the plain version and one SDPA call at rate 0.1, and the bound.
    ``sdpa_inputs()`` -> (q, k, v [B, H, T, hd], boolean mask); ``nbytes`` =
    (forward, backward) bytes of the function's own inputs and outputs;
    ``pairs`` = the (i, j) pairs that may attend, summed over batch and
    heads; ``hd_ops`` the head width the products run over."""
    import torch

    dname = str(dtype).split(".")[1]
    seed = torch.tensor([20240229], dtype=torch.int32, device=DEVICE)
    errs = {}
    for rate in (0.0, 0.1):
        outs = []
        for f in (fn, plain):
            a = qkv.clone().requires_grad_(True)
            b = qb.clone().requires_grad_(True)
            ctx = f(a, b, mask, seed, H, rate, scale)
            dqkv, dqb = torch.autograd.grad(ctx, (a, b), co)
            torch.cuda.synchronize()
            outs.append((ctx.detach().float(), dqkv.float(), dqb.float()))
            del a, b, ctx, dqkv, dqb
        for what, got, ref, tol in zip(("ctx", "dqkv", "dqb"), outs[0], outs[1],
                                       tols[dname]):
            check(bool(torch.isfinite(got).all()),
                  f"{name} {dname} B={B} rate {rate}: {what} not finite")
            e = (got - ref).abs().max().item()
            if what == "dqb":
                e /= max(ref.abs().max().item(), 1e-6)  # relative
            check(e <= tol, f"{name} {dname} B={B} rate {rate}: "
                  f"{what} max-abs {e:.3g} > {tol}")
            errs[f"{what}_rate{rate}"] = e
        errs["dqkv_largest"] = outs[1][1].abs().max().item()
        del outs
        torch.cuda.empty_cache()
    line = f"[{dname} B={B}] " + " ".join(f"{k} {v:.3g}" for k, v in errs.items())

    # timing, at the main path's rate (dropout 0.1)
    rate = 0.1
    fwd_bound = bound(nbytes[0], 4.0 * hd_ops * pairs, dname)
    bwd_bound = bound(nbytes[1], 10.0 * hd_ops * pairs, dname)
    timed = {}
    for label, f in (("kernel", fn), ("plain", plain)):
        with torch.no_grad():
            timed[f"{label}_fwd"] = device_ms(
                lambda: f(qkv, qb, mask, seed, H, rate, scale), reps=11, warmup=2)
        a = qkv.clone().requires_grad_(True)
        b = qb.clone().requires_grad_(True)
        ctx = f(a, b, mask, seed, H, rate, scale)
        timed[f"{label}_bwd"] = device_ms(
            lambda: torch.autograd.grad(ctx, (a, b), co, retain_graph=True),
            reps=11, warmup=2)
        del a, b, ctx
        torch.cuda.empty_cache()
    # the library yardstick: one SDPA call on the same q/k/v, mask, rate
    q, k, v, attn_mask = sdpa_inputs()
    q, k, v = (t.detach().contiguous().requires_grad_(True) for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=attn_mask, dropout_p=rate, scale=scale)
    with torch.no_grad():
        timed["library_fwd"] = device_ms(sdpa, reps=11, warmup=2)
    out = sdpa()
    do = torch.randn_like(out)
    timed["library_bwd"] = device_ms(
        lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
        reps=11, warmup=2)
    del q, k, v, out, do, attn_mask
    torch.cuda.empty_cache()
    results[(name, dname, B)] = dict(
        max_abs_err=max(errs["ctx_rate0.1"], errs["dqkv_rate0.1"]), errs=errs,
        ms=timed["kernel_fwd"] + timed["kernel_bwd"],
        plain_ms=timed["plain_fwd"] + timed["plain_bwd"],
        library_ms=timed["library_fwd"] + timed["library_bwd"],
        bound_ms=fwd_bound["bound_ms"] + bwd_bound["bound_ms"],
        bound_by=bwd_bound["bound_by"], fwd_bound=fwd_bound,
        bwd_bound=bwd_bound, **timed)
    return [line, f"[{dname} B={B} ms fwd/bwd] " + " ".join(
        f"{w} {timed[w + '_fwd']:.3f}/{timed[w + '_bwd']:.3f}"
        for w in ("kernel", "plain", "library"))
        + f" bound {fwd_bound['bound_ms']:.3f}/{bwd_bound['bound_ms']:.3f}"]


def _io_bytes(B, T, S, ctx_w, e_sz):
    """The function's own inputs read once and outputs written once: forward
    slab, qkv bias, [B, T] mask in, ctx out; backward slab, qkv bias, mask,
    d(ctx) in, dqkv and dqb out. What the kernels keep between the two (ctx,
    the row log-sum-exp) is their choice and is not counted."""
    return ((B * T * S + S + B * T * ctx_w) * e_sz + 4 * B * T,
            (2 * B * T * S + 2 * S + B * T * ctx_w) * e_sz + 4 * B * T)


def phase_train_attention(results, gen):
    """The three train-attention functions, forward + backward, vs their plain
    versions at their paths' layer shapes (H=12, hd=64)."""
    import torch

    from mmtg_tpu_torch.ops import train_attention as ta

    hd = TRAIN_HD
    S3 = 3 * H * hd
    scale = hd ** -0.5
    lines = {"mha_train_packed": [], "mha_train_packed_seg": [], "mha_train": []}

    def standard_heads(qkv, qb, B, T):
        heads = (qkv + qb).view(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
        return heads[0], heads[1], heads[2]

    def slab(B, T, dtype):
        return (torch.randn(B, T, S3, generator=gen, device=DEVICE).to(dtype),
                (torch.randn(S3, generator=gen, device=DEVICE) * 0.1).to(dtype),
                torch.randn(B, T, H * hd, generator=gen, device=DEVICE).to(dtype))

    # mha_train_packed: the unpacked train step's shape, a key-padding tail
    T = TRAIN_T
    for B in TRAIN_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv, qb, co = slab(B, T, dtype)
            bias = _key_bias(B, T)
            lines["mha_train_packed"] += _attention_vs_plain(
                results, "mha_train_packed", ta.mha_train_packed,
                ta.mha_train_packed_plain, dtype, B, qkv, qb, bias, co, scale,
                lambda: (*standard_heads(qkv, qb, B, T), _sdpa_mask(bias, T)),
                _io_bytes(B, T, S3, H * hd, qkv.element_size()),
                B * H * T * (T + 1) / 2, hd)
            del qkv, co
            torch.cuda.empty_cache()

    # mha_train_packed_seg: the packed step's shape, a real packed batch's ids
    B, T = PACK_ROWS, PACK_T
    _, batches = packed_batches(model_configs()[1], 5 * PACK_ROWS, PACK_ROWS, 5,
                                emb_size=8)
    seg = torch.from_numpy(batches[0]["seg"]).to(DEVICE)
    tril = torch.ones(T, T, dtype=torch.bool, device=DEVICE).tril()
    allowed = (seg[:, :, None] == seg[:, None, :]) & tril  # [B, T, T]
    pairs = float(H * int(allowed.sum()))  # what this batch's ids let attend
    for dtype in (torch.float32, torch.bfloat16):
        qkv, qb, co = slab(B, T, dtype)
        lines["mha_train_packed_seg"] += _attention_vs_plain(
            results, "mha_train_packed_seg", ta.mha_train_packed_seg,
            ta.mha_train_packed_seg_plain, dtype, B, qkv, qb, seg, co, scale,
            lambda: (*standard_heads(qkv, qb, B, T), allowed[:, None]),
            _io_bytes(B, T, S3, H * hd, qkv.element_size()), pairs, hd, tols=SEG_TOL)
        if dtype == torch.bfloat16:
            # what the tile test saves: the same kernels on one segment a row
            # (plain causal attention, no tile pair skipped)
            one, seed = torch.zeros_like(seg), torch.zeros(1, dtype=torch.int32,
                                                           device=DEVICE)
            with torch.no_grad():
                fwd = device_ms(lambda: ta.mha_train_packed_seg(
                    qkv, qb, one, seed, H, 0.1, scale), reps=11, warmup=2)
            a = qkv.clone().requires_grad_(True)
            ctx = ta.mha_train_packed_seg(a, qb, one, seed, H, 0.1, scale)
            bwd = device_ms(lambda: torch.autograd.grad(ctx, a, co, retain_graph=True),
                            reps=11, warmup=2)
            r = results[("mha_train_packed_seg", "bfloat16", B)]
            r["one_segment_fwd"], r["one_segment_bwd"] = fwd, bwd
            lines["mha_train_packed_seg"].append(
                f"[bfloat16 B={B} one segment a row, nothing skipped: kernel "
                f"{fwd:.3f}/{bwd:.3f}]")
            del a, ctx
        del qkv, co
        torch.cuda.empty_cache()
    results["seg_pairs_share"] = pairs / (B * H * T * (T + 1) / 2)
    del allowed

    # mha_train: the head-major slab of the same heads, each padded 64 -> 128
    B, T = TRAIN_BATCHES[-1], TRAIN_T
    for dtype in (torch.float32, torch.bfloat16):
        qkv, qb, _ = slab(B, T, dtype)
        pad = lambda t: torch.nn.functional.pad(  # noqa: E731
            t.reshape(t.shape[:-1] + (3, H, hd)), (0, ta.LANES - hd)).transpose(
                -3, -2).reshape(t.shape[:-1] + (H * ta.SLAB,)).contiguous()
        hm, hm_b = pad(qkv), pad(qb)
        co = torch.randn(B, T, H, ta.LANES, generator=gen, device=DEVICE)
        co[..., hd:] = 0.0  # as the padded output projection hands it back
        co = co.reshape(B, T, H * ta.LANES).to(dtype)
        bias = _key_bias(B, T)
        lines["mha_train"] += _attention_vs_plain(
            results, "mha_train", ta.mha_train, ta.mha_train_plain, dtype, B, hm,
            hm_b, bias, co, scale,
            lambda: (*standard_heads(qkv, qb, B, T), _sdpa_mask(bias, T)),
            _io_bytes(B, T, H * ta.SLAB, H * ta.LANES, qkv.element_size()),
            B * H * T * (T + 1) / 2, ta.LANES)
        # the pad lanes of everything it writes are zero, the live lanes are
        # the standard-slab kernel's numbers
        seed = torch.tensor([3], dtype=torch.int32, device=DEVICE)
        a = hm.clone().requires_grad_(True)
        ctx = ta.mha_train(a, hm_b, bias, seed, H, 0.1, scale)
        dqkv, = torch.autograd.grad(ctx, a, co)
        ref = ta.mha_train_packed(qkv, qb, bias, seed, H, 0.1, scale)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[1]
        check(ctx.view(B, T, H, ta.LANES)[..., hd:].abs().max().item() == 0.0
              and dqkv.view(B, T, H, 3, ta.LANES)[..., hd:].abs().max().item() == 0.0,
              f"mha_train {dname}: a pad lane of ctx or dqkv is not zero")
        e = (ctx.view(B, T, H, ta.LANES)[..., :hd].reshape(B, T, H * hd).float()
             - ref.float()).abs().max().item()
        check(e <= TRAIN_TOL[dname][0], f"mha_train {dname}: live lanes differ from "
              f"mha_train_packed by {e:.3g}")
        results[("mha_train", dname, B)]["vs_packed_ctx_max_abs"] = e
        del qkv, hm, co, a, ctx, dqkv, ref
        torch.cuda.empty_cache()
    return lines


def _full_width_inputs(dtype, seed, mcfg=None, dcfg=None):
    """Seeded parameters of ``mcfg`` (default: the repo's model) on the card,
    a random WenLan / CLIP table and a maker of synthetic prompt batches."""
    import torch

    from mmtg_tpu_torch.params import init_params

    if mcfg is None:
        mcfg, dcfg = model_configs()
    params = init_params(mcfg, seed=seed, dtype=dtype, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    V, E, P = mcfg.gpt2.vocab_size, dcfg.wenlan_emb_size, dcfg.topic_prompt_length
    table = torch.randn(V, E, generator=gen, device=DEVICE).to(dtype)

    def batch(b):
        return {
            "topic_ids": torch.randint(103, 8000, (b, P), generator=gen,
                                       device=DEVICE, dtype=torch.int32),
            "tpw_attention_mask": torch.ones(b, P, dtype=torch.int32, device=DEVICE),
            "tpw_type_ids": torch.ones(b, P, dtype=torch.int32, device=DEVICE),
            "topic_emb": torch.randn(b, E, generator=gen, device=DEVICE).to(dtype),
            "img_embs": torch.randn(b, 5, E, generator=gen, device=DEVICE).to(dtype),
            "r_embs": torch.randn(b, 5, E, generator=gen, device=DEVICE).to(dtype),
        }

    return mcfg, dcfg, params, {"wenlan_table": table}, batch


TRAIN_FNS = ("mha_train_packed", "mha_train_packed_seg", "mha_train")


def _counted():
    """name -> (object, attribute) of every launch count the port keeps."""
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import decode_megakernel as mk
    from mmtg_tpu_torch.ops import fused_gru as fg
    from mmtg_tpu_torch.ops import train_attention as ta

    counted = {fn.__name__: (fn, "launches") for fn in da.WRAPPERS}
    counted["decode_block_fused"] = (mk.decode_block_fused, "launches")
    counted["fused_gru"] = (fg.fused_gru, "launches")
    for name in TRAIN_FNS:
        counted[f"{name}_fwd"] = (getattr(ta, name), "fwd_launches")
        counted[f"{name}_bwd"] = (getattr(ta, name), "bwd_launches")
    return counted


def _counts():
    return {name: getattr(obj, attr) for name, (obj, attr) in _counted().items()}


def _reset_counts():
    for obj, attr in _counted().values():
        setattr(obj, attr, 0)


def _only(launches, expected, what):
    """The launch counts are ``expected`` and every other kernel's is 0."""
    want = {k: expected.get(k, 0) for k in launches}
    check(launches == want, f"{what}: launch counts {launches} != {want}")


def _check_tokens(toks, mcfg, dcfg, what):
    import torch

    from mmtg_tpu_torch.configs import SpecialTokens
    from mmtg_tpu_torch.ops.sampling import frame_forced_token

    check(toks.shape == (toks.shape[0], LENGTH + 1) and toks.dtype == torch.int32,
          f"{what}: tokens {tuple(toks.shape)} {toks.dtype}")
    V = mcfg.gpt2.vocab_size
    check(bool(((toks >= 0) & (toks < V)).all()), f"{what}: token id out of range")
    check(bool((toks[:, 0] == SpecialTokens().start_id).all()), f"{what}: no START")
    for i in range(LENGTH):
        forced, fid = frame_forced_token(i, dcfg.sent_frame_length)
        if forced:
            check(bool((toks[:, i + 1] == fid).all()),
                  f"{what}: position {i + 1} is not the forced token {fid}")


def phase_generate(out, gpu):
    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0)
    steps = mcfg.gpt2.n_layer * LENGTH  # one launch per layer and step
    runs = [("b64 int8 cache", 64, GenerateConfig(cache_dtype="int8"),
             {"decode_attention_int8_append": steps, "fused_gru": 2}),
            ("b8 bf16 cache", 8, GenerateConfig(cache_dtype="model"),
             {"decode_attention_fp_append": steps, "fused_gru": 2}),
            # the p50 path: one row, the bf16 cache
            ("b1 bf16 cache", 1, GenerateConfig(cache_dtype="model"),
             {"decode_attention_fp_append": steps, "fused_gru": 2})]
    batches = {b: make_batch(b) for _, b, _, _ in runs}
    for _, b, gcfg, _ in runs:  # warm-up (cuBLAS handles, allocator)
        generate(params, const, mcfg, dcfg, gcfg, batches[b],
                 torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()

    _reset_counts()  # ---- the main path starts here --------------------------
    lines, before = [], _counts()
    for what, b, gcfg, expected in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(params, const, mcfg, dcfg, gcfg, batches[b],
                        torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = _counts()
        got = {k: now[k] - before[k] for k in now}
        before = now
        _only(got, expected, what)
        _check_tokens(toks, mcfg, dcfg, what)
        tps = b * LENGTH / wall
        out[f"generate_{what.replace(' ', '_')}"] = dict(
            wall_s=wall, tok_per_s=tps, launches=got)
        lines.append(f"{what}: {wall:.3f} s, {tps:.1f} tok/s, launches "
                     f"{ {k: v for k, v in got.items() if v} }")
    launches = _counts()  # ---- read just after the main path ---------------
    # B=1 p50: the run above and P50_CALLS - 1 more of the same call
    what, b, gcfg, _ = runs[-1]
    walls = [out[f"generate_{what.replace(' ', '_')}"]["wall_s"]]
    for _ in range(P50_CALLS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(params, const, mcfg, dcfg, gcfg, batches[b],
                 torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    p50 = statistics.median(walls)
    out["generate_b1_p50"] = dict(p50_s=p50, walls_s=walls, tok_per_s=LENGTH / p50)
    lines.append(f"b1 p50 of {P50_CALLS} calls {p50:.3f} s ({LENGTH / p50:.1f} tok/s)")
    print(f"phase 3 generate (full width, bf16, {LENGTH} tokens, on {gpu}): ok; "
          + "; ".join(lines))
    return launches


def phase_oracle(out):
    """The read-only kernels in the role the JAX package gives them: after an
    append kernel has written slot `position`, the read-only kernel of the same
    cache kind, on the cache just written, gives the same context bit for bit
    (both run the same attend stage). A kernel against a kernel: no plain
    version is involved. Full width, B=64, T=256."""
    import torch

    from mmtg_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=DEVICE).manual_seed(10)
    pairs = (("fp", da.decode_attention_fp_append, da.decode_attention),
             ("int8", da.decode_attention_int8_append, da.decode_attention_int8),
             ("int4", da.decode_attention_int4_append, da.decode_attention_int4),
             ("merged", da.decode_attention_int8_append_merged, da.decode_attention_int8))
    _reset_counts()  # ---- this path starts here ------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        for kind, append, read in pairs:
            q, k_new, v_new, mask, caches, scales = _attention_case(dtype, kind, gen)
            for pos in POSITIONS:
                layer = pos % L
                ctx = append(q, k_new, v_new, *caches, *scales, mask, pos, layer, n_head=H)
                split = caches
                if kind == "merged":  # the read-only kernel takes the split halves
                    split = [caches[0][layer:layer + 1, ..., :D].contiguous(),
                             caches[0][layer:layer + 1, ..., D:].contiguous()]
                    again = read(q, *split, *(s[layer:layer + 1] for s in scales), mask,
                                 pos, 0, n_head=H)
                else:
                    again = read(q, *split, *scales, mask, pos, layer, n_head=H)
                torch.cuda.synchronize()
                check(torch.equal(ctx, again), f"oracle {kind} {dtype} pos {pos}: the "
                      "read-only kernel disagrees with the append kernel")
            del caches, scales
            torch.cuda.empty_cache()
    launches = _counts()  # ---- read just after ---------------------------------
    n = 2 * len(POSITIONS)
    _only(launches, {"decode_attention_fp_append": n, "decode_attention": n,
                     "decode_attention_int8_append": n, "decode_attention_int8": 2 * n,
                     "decode_attention_int4_append": n, "decode_attention_int4": n,
                     "decode_attention_int8_append_merged": n}, "oracle")
    out["oracle"] = dict(launches=launches)
    print(f"phase 11 read-only kernels as oracles (append, then read the cache just "
          f"written: same ctx bit for bit; fp / int8 / int4 / merged, f32 and bf16, "
          f"{len(POSITIONS)} positions): ok")
    return launches


def phase_generate_serving(out, gpu):
    """The serving decode paths of decoding.generate at full width, B=64, bf16,
    220 tokens: int4 cache, merged k||v cache, the whole-step kernel, beside
    the int8 per-layer path of the same run; launch counts asserted."""
    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0)
    steps = mcfg.gpt2.n_layer * LENGTH  # per-layer kernels: one launch a layer and step
    base = dict(weight_dtype="model")
    runs = [("int8 per-layer", GenerateConfig(cache_dtype="int8", **base),
             {"decode_attention_int8_append": steps}),
            ("int4 cache", GenerateConfig(cache_dtype="int4", **base),
             {"decode_attention_int4_append": steps}),
            ("merged kv", GenerateConfig(cache_dtype="int8", merged_kv=True, **base),
             {"decode_attention_int8_append_merged": steps}),
            ("fused", GenerateConfig(cache_dtype="int8", attn_impl="fused", **base),
             {"decode_block_fused": LENGTH})]
    batch = make_batch(64)
    for _, gcfg, _ in runs:  # warm-up
        generate(params, const, mcfg, dcfg, gcfg, batch,
                 torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()

    _reset_counts()  # ---- the main path starts here --------------------------
    lines, before, res = [], _counts(), {}
    for what, gcfg, expected in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(params, const, mcfg, dcfg, gcfg, batch,
                        torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = _counts()
        got = {k: now[k] - before[k] for k in now}
        before = now
        _only(got, {**expected, "fused_gru": 2}, what)
        _check_tokens(toks, mcfg, dcfg, what)
        res[what] = dict(wall_s=wall, tok_per_s=64 * LENGTH / wall, launches=got)
        lines.append(f"{what}: {wall:.3f} s, {64 * LENGTH / wall:.1f} tok/s, "
                     f"launches {expected}")
    launches = _counts()  # ---- read just after the main path ---------------
    out["generate_serving_b64"] = res
    print(f"phase 12 generate, serving decode paths (full width, bf16, B=64, {LENGTH} "
          f"tokens, weights bf16, on {gpu}): ok; " + "; ".join(lines))
    return launches


def phase_stream(out, gpu):
    """generate_stream with per-row seeds at B=64 vs generate with the same
    seeds: equal token for token; the time to the first block."""
    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate, generate_stream
    from mmtg_tpu_torch.ops import prng

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0)
    gcfg = GenerateConfig(cache_dtype="int8", weight_dtype="model")
    batch = make_batch(64)
    key = prng.PRNGKey(11, device=DEVICE)
    seeds = torch.arange(64, dtype=torch.int32, device=DEVICE) * 7 - 100
    _reset_counts()
    full = generate(params, const, mcfg, dcfg, gcfg, batch, key, row_seeds=seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks, first_s = [], None
    for blk in generate_stream(params, const, mcfg, dcfg, gcfg, batch, key,
                               row_seeds=seeds):
        host = blk.cpu()  # a client reads the block: wait for the device
        if first_s is None:
            first_s = time.perf_counter() - t0
        blocks.append(host)
    total_s = time.perf_counter() - t0
    check([b.shape[1] for b in blocks] == [22] * 10, "stream: blocks are not 10 x 22")
    check(torch.equal(torch.cat(blocks, dim=1), full[:, 1:].cpu()),
          "stream: the blocks differ from generate with the same seeds")
    _check_tokens(full, mcfg, dcfg, "stream")
    # another companion set, the same seeds: row 0's tokens do not move
    alone = generate(params, const, mcfg, dcfg, gcfg,
                     {k: v[:8] for k, v in batch.items()}, key, row_seeds=seeds[:8])
    same = bool(torch.equal(alone[0], full[0]))
    launches = _counts()
    # three decodes (one-shot, streamed, the batch of 8), per-layer kernels
    _only(launches, {"decode_attention_int8_append": 3 * mcfg.gpt2.n_layer * LENGTH,
                     "fused_gru": 6}, "stream")
    out["stream_b64"] = dict(first_block_s=first_s, total_s=total_s,
                             row0_same_in_a_batch_of_8=same)
    print(f"phase 13 generate_stream with row_seeds (full width, bf16, B=64, on {gpu}): "
          f"ok; 10 blocks of 22 equal generate token for token; first block after "
          f"{first_s:.3f} s, all after {total_s:.3f} s; row 0 in a batch of 8 with the "
          f"same seed: {'the same tokens' if same else 'other tokens (bf16 products differ by batch shape)'}")
    return launches


def phase_serve(out, gpu, paths, model):
    """The service as its CLI builds it (serve.build_service from parsed flags,
    default device: the card) at full width: concurrent requests through
    submit, one streamed over HTTP on a local port, each held against generate
    with the same seeds; /reload once; a clean stop."""
    import json as _json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from mmtg_tpu_torch import decoding, serve
    from mmtg_tpu_torch.data import MMTGDataset, make_synthetic_records
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    mcfg, dcfg = model_configs()
    args = serve.build_arg_parser().parse_args([
        "--model_path", model, "--tokenizer_path", paths["vocab"],
        "--token_emb_path", paths["emb"], "--buckets", "4,8", "--max_wait_ms", "200",
        "--seed", "5", "--cache_dtype", "int8", "--weight_dtype", "model",
        "--attn_impl", "fused"])
    t0 = time.perf_counter()
    service, tok = serve.build_service(args)
    check(service.device.type == DEVICE, f"service on {service.device}")
    service.warmup(bucket=4)
    warm_s = time.perf_counter() - t0
    records = make_synthetic_records(5, np.random.default_rng(3),
                                     emb_size=dcfg.wenlan_emb_size)
    for r in records:
        r.pop("rating")
    ds = MMTGDataset.from_records(records, WordPieceTokenizer.from_file(paths["vocab"]),
                                  dcfg, if_train=False)
    samples = [{k: np.asarray(ds[i][k]) for k in serve.SAMPLE_KEYS} for i in range(5)]

    def direct(rows, seeds):
        # the window as the service packs it: the rows, then pad rows that
        # repeat row 0 with seed 0, up to the bucket
        reqs = [serve._Pending(s, seed, None) for s, seed in zip(rows, seeds)]
        batch, seed_t = service._pack(reqs, service._bucket_for(len(reqs)))
        return decoding.generate(service.params, service.const, mcfg, dcfg,
                                 service.gcfg, batch, prng.PRNGKey(5, device=DEVICE),
                                 row_seeds=seed_t).cpu().numpy()[:len(rows)]

    httpd = serve.serve_http(service, port=0, tokenizer=tok)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        _reset_counts()  # ---- the main path starts here ----------------------
        t0 = time.perf_counter()
        futs = [service.submit(samples[i], seed=40 + i) for i in range(4)]
        got = [f.result(timeout=300) for f in futs]
        batch_s = time.perf_counter() - t0
        body = serve.encode_request_npz(samples[4], seed=77)
        req = urllib.request.Request(
            f"http://localhost:{port}/generate_stream", data=body,
            headers={"Content-Type": serve.NPZ_CONTENT_TYPE})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            first_s, raw = None, b""
            while True:
                line = r.readline()
                if not line:
                    break
                if first_s is None and line.startswith(b"data: "):
                    first_s = time.perf_counter() - t0
                raw += line
        stream_s = time.perf_counter() - t0
        launches = _counts()  # ---- read just after the main path -----------
        events = [_json.loads(ev[len("data: "):]) for ev in raw.decode().split("\n\n")
                  if ev.startswith("data: ")]
        check(events[-1].get("done") is True and events[-1]["tokens_total"] == LENGTH,
              f"serve stream: last event {events[-1]}")
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        want = direct(samples[:4], [40, 41, 42, 43])
        for i in range(4):
            check(np.array_equal(got[i], want[i]), f"serve: response {i} differs from "
                  "generate with the same seeds")
        _check_tokens(torch.from_numpy(np.stack(got)), mcfg, dcfg, "serve")
        want_s = direct([samples[4]], [77])[0]
        check(np.array_equal(np.asarray([int(want_s[0])] + streamed), want_s),
              "serve: the streamed response differs from generate with the same seed")
        # 4 one-shot rows in one window (1 launch a step), the stream's window
        # in 10 blocks (1 launch a step); the encoder's two GRUs per window
        _only(launches, {"decode_block_fused": 2 * LENGTH, "fused_gru": 4}, "serve")
        req = urllib.request.Request(
            f"http://localhost:{port}/reload", data=_json.dumps({"model_path": model}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            check(_json.loads(r.read())["ok"] is True, "serve: /reload failed")
        again = service.generate_sync(samples[0], seed=40, timeout=300)
        check(np.array_equal(again, direct([samples[0]], [40])[0]),
              "serve: after /reload the response differs from generate")
        with urllib.request.urlopen(f"http://localhost:{port}/healthz", timeout=30) as r:
            check(_json.loads(r.read()) == {"ok": True}, "serve: /healthz")
        stats = service.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(60)
        service.stop()
    check(not th.is_alive() and service._thread is None, "serve: a thread is left")
    check(stats["batches"] == 3 and stats["served"] == 6 and stats["errors"] == 0,
          f"serve: stats {stats}")
    out["serve"] = dict(build_and_warmup_s=warm_s, window_of_4_s=batch_s,
                        stream_first_event_s=first_s, stream_total_s=stream_s,
                        stats=stats, launches=launches)
    print(f"phase 14 serve (build_service from CLI flags, full width, f32, buckets 4,8, "
          f"attn_impl=fused, on {gpu}): ok; started and warmed in {warm_s:.1f} s; 4 "
          f"concurrent requests in one window {batch_s:.3f} s; 1 request streamed over "
          f"HTTP: first sentence after {first_s:.3f} s, all after {stream_s:.3f} s; every "
          f"response equals generate with the same seeds; /reload ok; stopped cleanly; "
          f"{launches['decode_block_fused']} launches of decode_block_fused")
    return launches


TF_STEPS = 60  # teacher-forced tokens: past the 44-token window and two frames


def _framed_tokens(b, K, seed):
    """``[b, K]`` int32 teacher-forcing tokens on the sentence frame: START
    opens and EOS closes every 22-token sentence, random ids between."""
    import torch

    from mmtg_tpu_torch.configs import SpecialTokens

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tokens = torch.randint(103, 8000, (b, K), generator=gen, device=DEVICE,
                           dtype=torch.int32)
    sp = SpecialTokens()
    tokens[:, 0] = sp.start_id
    for j in range(K):
        if j % 22 == 21:
            tokens[:, j] = sp.eos_id
        elif j and j % 22 == 0:
            tokens[:, j] = sp.start_id
    return tokens


def phase_teacher_forced(out):
    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import teacher_forced_decode_logits

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.float32, 2)
    batch = make_batch(8)
    K = TF_STEPS
    tokens = _framed_tokens(8, K, 3)
    errs, kernel_logits = {}, {}
    forms = {"model": dict(cache_dtype="model"), "int8": dict(cache_dtype="int8"),
             "int4": dict(cache_dtype="int4"),
             "merged": dict(cache_dtype="int8", merged_kv=True),
             "fused": dict(cache_dtype="int8", attn_impl="fused")}
    for form, kw in forms.items():
        gcfg = GenerateConfig(**kw)
        a = teacher_forced_decode_logits(params, const, mcfg, dcfg, gcfg, batch,
                                         tokens, use_kernels=True)
        b = teacher_forced_decode_logits(params, const, mcfg, dcfg, gcfg, batch,
                                         tokens, use_kernels=False)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a).all()), f"teacher-forced {form}: non-finite")
        errs[form] = (a - b).abs().max().item()
        kernel_logits[form] = a
    # the whole-step kernel against the per-layer kernels, both on the card
    errs["fused_vs_per_layer"] = (
        kernel_logits["fused"] - kernel_logits["int8"]).abs().max().item()
    for form, tol in TEACHER_FORCED_TOL.items():
        check(errs[form] <= tol, f"teacher-forced f32 logits over {K} steps, {form}: "
              f"max-abs {errs[form]:.3g} > {tol}")
    # the merged layout is the split one bit for bit, through the whole engine
    check(torch.equal(kernel_logits["merged"], kernel_logits["int8"]),
          "teacher-forced: merged cache logits differ from the split cache's")
    out["teacher_forced_max_abs"] = errs
    print(f"phase 4 teacher-forced logits (full width, f32, B=8, {K} tokens), "
          f"kernels vs plain, max-abs: ok; "
          + "; ".join(f"{k} {errs[k]:.3g} (<= {tol})"
                      for k, tol in TEACHER_FORCED_TOL.items())
          + "; merged equals split bit for bit")


def _train_batch(b, dcfg, seed):
    """``b`` synthetic train rows through the repo's own dataset code, as
    device tensors, every rating 5 (stage 3 keeps all, y = 1)."""
    import numpy as np
    import torch

    from mmtg_tpu_torch.data import MMTGDataset, make_synthetic_records
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    here = os.path.dirname(os.path.abspath(__file__))
    tok = WordPieceTokenizer.from_file(os.path.join(here, "vocab", "vocab.txt"))
    records = make_synthetic_records(b, np.random.default_rng(seed),
                                     emb_size=dcfg.wenlan_emb_size)
    for r in records:
        r["rating"] = 5.0
    ds = MMTGDataset.from_records(records, tok, dcfg, if_train=True)
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in next(ds.batches(batch_size=b)).items()}


def _timed_steps(step, state, const, batches, warm, steps):
    """``warm`` warm-up steps, then the counts set to 0, ``steps`` timed steps
    (each ending in a synchronize) over ``batches`` in turn, and the counts
    read. Returns (state, dict of what was measured)."""
    import torch

    for i in range(warm):  # also the schedule's rate-0 first update
        state, m = step(state, const, batches[i % len(batches)], 3)
    torch.cuda.synchronize()

    _reset_counts()  # ---- the main path starts here --------------------------
    losses, times, kept = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = batches[(warm + i) % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, const, batch, 3)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        kept.append(float(m["kept"]))
    launches = _counts()  # ---- read just after the main path -----------------
    step_ms = statistics.median(times) * 1e3
    return state, dict(
        step_ms=step_ms, samples_per_step=statistics.mean(kept),
        samples_per_s=statistics.mean(kept) / (step_ms / 1e3), losses=losses,
        step_ms_all=[t * 1e3 for t in times], kept=kept,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)


def _check_trained(what, r, state):
    import torch

    from mmtg_tpu_torch.params import tree_leaves

    losses = r["losses"]
    check(all(torch.isfinite(torch.tensor(losses))), f"{what}: loss not finite {losses}")
    check(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
          f"{what}: a parameter is not finite")


def _profile_step(out, key, what, step, state, const, batch):
    """A torch.profiler kernel-time split of one train step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, const, batch, 3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: an operator's row repeats its kernels' time
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    check(bool(rows), f"{what} profile: torch.profiler recorded no kernel")
    groups = {}
    for name, us, _ in rows:
        low = name.lower()
        group = ("attention kernels (mha_*)" if "mha_" in low else
                 "GEMM" if any(w in low for w in ("nvjet", "gemm", "cutlass", "cublas")) else
                 "indexing / gather backward" if "index" in low or "gather" in low
                 or "scatter" in low else
                 "reductions (LayerNorm stats, softmax, sums)" if "reduce" in low
                 or "softmax" in low else
                 "random bits (dropout masks)" if "distribution" in low
                 or "philox" in low or "random" in low else
                 "elementwise" if "elementwise" in low else "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    total = sum(groups.values())
    out[key] = dict(
        wall_ms=wall_ms, device_ms=total, busy_share=total / wall_ms,
        groups_ms=groups,
        kernels=[dict(name=n[:120], ms=us / 1e3, calls=c) for n, us, c in rows[:25]])
    print(f"{what} profile (one step under torch.profiler): wall "
          f"{wall_ms:.1f} ms, kernel time {total:.1f} ms (busy share "
          f"{total / wall_ms:.3f}); " + "; ".join(
              f"{g} {ms:.1f} ms" for g, ms in sorted(groups.items(),
                                                     key=lambda kv: -kv[1])))
    return state


def _loss_and_grads(params, const, mcfg, dcfg, batch, impl):
    """f32, no dropout, no remat: (total, gradient leaves)."""
    import torch

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import TrainConfig
    from mmtg_tpu_torch.params import tree_leaves

    cfg = TrainConfig(dtype="float32", remat=False, alpha=0.2, attn_impl=impl)
    total, _ = ttrain.loss_and_metrics(params, const, mcfg, dcfg, cfg, batch, 3,
                                       None, True)
    grads = torch.autograd.grad(total, tree_leaves(params))
    torch.cuda.synchronize()
    return float(total.detach()), grads


def _compare_paths(out, key, what, params, const, mcfg, dcfg, batch, impls):
    """Loss and every gradient leaf through ``impls[0]`` vs ``impls[1]``."""
    from mmtg_tpu_torch.params import tree_map

    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    a, b = (_loss_and_grads(params, const, mcfg, dcfg, batch, impl) for impl in impls)
    loss_err = abs(a[0] - b[0])
    grad_err = max((x - y).abs().max().item() for x, y in zip(a[1], b[1]))
    grad_max = max(y.abs().max().item() for y in b[1])
    check(loss_err <= 1e-4, f"{what}: loss {impls[0]} vs {impls[1]} differ by {loss_err:.3g}")
    check(grad_err <= 1e-4, f"{what}: a gradient leaf differs by {grad_err:.3g} > 1e-4")
    out[key] = dict(loss_abs_err=loss_err, grad_max_abs_err=grad_err,
                    grad_max=grad_max, leaves=len(b[1]))
    print(f"{what}, {impls[0]} path vs {impls[1]} path (full width, f32, no "
          f"dropout): ok; loss |diff| {loss_err:.3g}, {len(b[1])} gradient "
          f"leaves max-abs {grad_err:.3g} (<= 1e-4; largest gradient {grad_max:.3g})")


def _train_state(params, mcfg, dcfg, attn_impl="auto", dtype="bfloat16"):
    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import TrainConfig

    tcfg = TrainConfig(dtype=dtype, remat=True, lr=1e-4, alpha=0.2,
                       attn_impl=attn_impl)
    state, tx = ttrain.create_train_state(7, mcfg, tcfg, 1, 200, params,
                                          device=DEVICE)
    return state, ttrain.make_train_step(mcfg, dcfg, tcfg, tx)


def phase_train(out, gpu, profile):
    import torch

    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7)
    L = mcfg.gpt2.n_layer
    B, WARM, STEPS = TRAIN_BATCHES[-1], 1, 5
    state, step = _train_state(params, mcfg, dcfg)
    batch = _train_batch(B, dcfg, 8)
    state, r = _timed_steps(step, state, const, [batch], WARM, STEPS)
    launches = r["launches"]
    _check_trained("train", r, state)
    # forward + remat forward, one backward, per layer and step; nothing else
    _only(launches, {"mha_train_packed_fwd": 2 * L * STEPS,
                     "mha_train_packed_bwd": L * STEPS}, "train")
    out["train_b64"] = r
    print(f"phase 6 train (full width, bf16 compute / f32 masters, B={B}, "
          f"dropout on, remat, {STEPS} steps, on {gpu}): ok; median step "
          f"{r['step_ms']:.1f} ms, {r['samples_per_s']:.1f} samples/s, loss "
          f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, peak "
          f"{r['peak_memory_gib']:.1f} GiB, launches fwd "
          f"{launches['mha_train_packed_fwd']} bwd {launches['mha_train_packed_bwd']}")
    if profile:
        state = _profile_step(out, "train_profile", f"train B={B}", step, state,
                              const, batch)
    del state, step, batch
    torch.cuda.empty_cache()
    _compare_paths(out, "train_kernel_vs_plain", "phase 6 train B=8", params, const,
                   mcfg, dcfg, _train_batch(8, dcfg, 9), ("kernel", "plain"))
    return launches


def phase_train_packed(out, gpu, profile):
    """The packed-sequence train path: make_train_step on PackedBatcher
    batches, 32 rows of 512 (the token count of phase 6's B=64 x 256)."""
    import torch

    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7)
    L = mcfg.gpt2.n_layer
    WARM, STEPS = 1, 5
    pb, np_batches = packed_batches(dcfg, 24 * PACK_ROWS, PACK_ROWS, 11)
    check(len(np_batches) >= WARM + STEPS, f"only {len(np_batches)} full packed batches")
    to_dev = lambda b: {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}  # noqa: E731
    batches = [to_dev(b) for b in np_batches[:WARM + STEPS]]
    live = [float((b["seg"] < PACK_SLOTS).float().mean()) for b in batches]
    state, step = _train_state(params, mcfg, dcfg)
    state, r = _timed_steps(step, state, const, batches, WARM, STEPS)
    launches = r["launches"]
    _check_trained("packed train", r, state)
    _only(launches, {"mha_train_packed_seg_fwd": 2 * L * STEPS,
                     "mha_train_packed_seg_bwd": L * STEPS}, "packed train")
    check(r["kept"] == [float(b["slot_valid"].sum()) for b in batches[WARM:]],
          f"packed train: kept {r['kept']} is not the batches' real sample count")
    r.update(density=pb.density, row_fill=statistics.mean(live), rows=PACK_ROWS,
             row_len=PACK_T)
    out["train_packed"] = r
    print(f"phase 8 packed train (full width, bf16 compute / f32 masters, "
          f"{PACK_ROWS} rows of {PACK_T}, <= {PACK_SLOTS} samples a row, dropout on, "
          f"remat, {STEPS} steps, on {gpu}): ok; median step {r['step_ms']:.1f} ms, "
          f"{r['samples_per_step']:.1f} real samples a step, "
          f"{r['samples_per_s']:.1f} samples/s, packing density {pb.density:.3f} "
          f"(real/grid tokens), row fill {r['row_fill']:.3f}, loss "
          f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, peak "
          f"{r['peak_memory_gib']:.1f} GiB, launches fwd "
          f"{launches['mha_train_packed_seg_fwd']} bwd "
          f"{launches['mha_train_packed_seg_bwd']}")
    if profile:
        state = _profile_step(out, "train_packed_profile", "packed train", step,
                              state, const, batches[0])
    del state, step, batches
    torch.cuda.empty_cache()
    _, small = packed_batches(dcfg, 24, 4, 12)
    _compare_paths(out, "train_packed_kernel_vs_plain", "phase 8 packed train, 4 rows",
                   params, const, mcfg, dcfg, to_dev(small[0]), ("kernel", "plain"))
    # rows of n_positions = 1024 (--pack_row_len 1024), the same tokens a step:
    # one warm-up and one timed step in bf16, then in f32
    _, np_long = packed_batches(dcfg, 16 * LONG_ROWS, LONG_ROWS, 13, row_len=LONG_T)
    check(len(np_long) >= 2, f"only {len(np_long)} full packed batches of {LONG_T}")
    long_batches = [to_dev(b) for b in np_long[:2]]
    long = {}
    for dname in ("bfloat16", "float32"):
        state, step = _train_state(params, mcfg, dcfg, dtype=dname)
        state, m = step(state, const, long_batches[0], 3)
        torch.cuda.synchronize()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, const, long_batches[1], 3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = _counts()
        loss = float(m["loss"])
        check(loss == loss and abs(loss) < 1e6, f"packed {dname} step at {LONG_T}: loss {loss}")
        _only(got, {"mha_train_packed_seg_fwd": 2 * L, "mha_train_packed_seg_bwd": L},
              f"packed {dname} step at {LONG_T}")
        long[dname] = dict(step_ms=wall_ms, loss=loss, kept=float(m["kept"]),
                           peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state, step
        torch.cuda.empty_cache()
    out["train_packed_long_rows"] = dict(rows=LONG_ROWS, row_len=LONG_T, **long)
    print(f"phase 8 packed train at --pack_row_len {LONG_T} ({LONG_ROWS} rows, full "
          f"width, dropout on, remat, on {gpu}): ok; " + "; ".join(
              f"{k}: one step {v['step_ms']:.1f} ms, {v['kept']:.0f} real samples, "
              f"loss {v['loss']:.4f}" for k, v in long.items()))
    return launches


def phase_train_head_major(out, gpu):
    """The unpacked train step through mha_train (attn_impl="kernel_padded")."""
    import torch

    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7)
    L = mcfg.gpt2.n_layer
    B, WARM, STEPS = TRAIN_BATCHES[-1], 1, 3
    state, step = _train_state(params, mcfg, dcfg, attn_impl="kernel_padded")
    state, r = _timed_steps(step, state, const, [_train_batch(B, dcfg, 8)], WARM, STEPS)
    launches = r["launches"]
    _check_trained("head-major train", r, state)
    _only(launches, {"mha_train_fwd": 2 * L * STEPS, "mha_train_bwd": L * STEPS},
          "head-major train")
    out["train_head_major_b64"] = r
    print(f"phase 9 head-major train (attn_impl=kernel_padded, full width, bf16, "
          f"B={B}, dropout on, remat, {STEPS} steps, on {gpu}): ok; median step "
          f"{r['step_ms']:.1f} ms (phase 6: {out['train_b64']['step_ms']:.1f} ms), "
          f"{r['samples_per_s']:.1f} samples/s, loss {r['losses'][0]:.4f} -> "
          f"{r['losses'][-1]:.4f}, peak {r['peak_memory_gib']:.1f} GiB, launches fwd "
          f"{launches['mha_train_fwd']} bwd {launches['mha_train_bwd']}")
    del state, step
    torch.cuda.empty_cache()
    _compare_paths(out, "train_head_major_vs_packed", "phase 9 head-major train B=8",
                   params, const, mcfg, dcfg, _train_batch(8, dcfg, 9),
                   ("kernel_padded", "kernel"))
    return launches


def _cli_fixtures(tmp, dcfg):
    """Synthetic test / train / val pickles and a token-embedding table."""
    import numpy as np

    from mmtg_tpu_torch.data import make_synthetic_records

    rng = np.random.default_rng(0)
    paths = {}
    for name, n in (("test", 2), ("train", 16), ("val", 8)):
        records = make_synthetic_records(n, rng, emb_size=dcfg.wenlan_emb_size)
        if name == "test":
            for r in records:
                r.pop("rating")
        paths[name] = os.path.join(tmp, f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(records, f)
    paths["emb"] = os.path.join(tmp, "token_id2emb_dict.pkl")
    with open(paths["emb"], "wb") as f:
        pickle.dump({i: v for i, v in enumerate(
            rng.standard_normal((13317, dcfg.wenlan_emb_size)).astype(np.float32))}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    paths["vocab"] = os.path.join(here, "vocab", "vocab.txt")
    return paths


def _reference_checkpoint(tmp):
    """A full-width reference .pth of seeded random weights."""
    from mmtg_tpu_torch.checkpoint import save_reference_checkpoint
    from mmtg_tpu_torch.params import init_params

    mcfg, _ = model_configs()
    model = os.path.join(tmp, "model.pth")
    save_reference_checkpoint(model, init_params(mcfg, seed=5), mcfg)
    return model


def phase_cli(out, paths, tmp, model):
    import torch

    from mmtg_tpu_torch import generate as cli

    mcfg, dcfg = model_configs()
    samples = os.path.join(tmp, "samples.txt")
    t0 = time.perf_counter()
    cli.main(["--data_path", paths["test"], "--model_path", model,
              "--tokenizer_path", paths["vocab"], "--token_emb_path", paths["emb"],
              "--batch_size", "4", "--n_samples", "2", "--save_samples",
              "--save_samples_path", samples, "--device", DEVICE],
             mcfg=mcfg, dcfg=dcfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with open(samples, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == 4, f"CLI wrote {len(lines)} lines for 4 samples")
    check(all(ln.strip() for ln in lines), "CLI wrote an empty sample")
    out["cli"] = dict(seconds=secs, samples=len(lines))
    print(f"phase 5 CLI: ok; {len(lines)} samples in {secs:.1f} s, first: "
          f"{lines[0][:40]!r}")


def phase_train_cli(out, paths, tmp):
    """python -m mmtg_tpu_torch.train with no --device (so: on the card), at
    the full width with the depth cut to 2 layers: one epoch, its
    checkpoints, then a resumed second epoch."""
    import dataclasses

    import torch

    from mmtg_tpu_torch import train as cli

    mcfg, dcfg = model_configs()
    mcfg = dataclasses.replace(mcfg, gpt2=dataclasses.replace(mcfg.gpt2, n_layer=2))
    save = os.path.join(tmp, "ckpt")
    args = ["--train_data_path", paths["train"], "--val_data_path", paths["val"],
            "--vocab_path", paths["vocab"], "--token_emb_path", paths["emb"],
            "--batch_size", "8", "--val_batch_size", "8", "--curriculums", "0,0",
            "--alpha", "0.2", "--lr", "1e-4", "--val_interval_ratio", "1.0",
            "--log_interval", "1", "--save_model", "--save_path", save]
    _reset_counts()
    t0 = time.perf_counter()
    val1 = cli.main(args + ["--epochs", "1"], mcfg=mcfg, dcfg=dcfg)
    state_dir = os.path.join(save, "train_state")
    first = sorted(os.listdir(state_dir))
    check(first == ["step_00000002.pt"], f"train CLI checkpoints: {first}")
    val2 = cli.main(args + ["--epochs", "2", "--resume"], mcfg=mcfg, dcfg=dcfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    second = sorted(os.listdir(state_dir))
    check(second == ["step_00000002.pt", "step_00000004.pt"],
          f"train CLI checkpoints after --resume: {second}")
    check(val1 == val1 and val2 == val2 and abs(val1) < 1e6 and abs(val2) < 1e6,
          f"train CLI: val loss not finite ({val1}, {val2})")
    counts = _counts()
    # 4 train steps x 2 layers x (fwd + remat fwd), plus the eval forwards
    check(counts["mha_train_packed_bwd"] == 4 * 2
          and counts["mha_train_packed_fwd"] > 2 * 4 * 2,
          f"train CLI: launch counts {counts}")
    # the generate CLI (no --device: the card) on the save path just written
    from mmtg_tpu_torch import generate as gen_cli
    from mmtg_tpu_torch.checkpoint import newest_step_file

    loaded = newest_step_file(save)
    best = os.path.join(save, "train_state_best")
    check(os.path.dirname(loaded) == (best if os.path.isdir(best) else state_dir),
          f"generate CLI: {loaded} is not the preferred stream's newest step")
    samples = os.path.join(tmp, "samples_trained.txt")
    _reset_counts()
    t0 = time.perf_counter()
    gen_cli.main(["--data_path", paths["test"], "--model_path", save,
                  "--tokenizer_path", paths["vocab"], "--token_emb_path", paths["emb"],
                  "--batch_size", "4", "--n_samples", "2", "--save_samples",
                  "--save_samples_path", samples], mcfg=mcfg, dcfg=dcfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = _counts()
    with open(samples, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == 4 and all(ln.strip() for ln in lines),
          f"generate CLI on the train save path wrote {lines}")
    # B=4: the int8 cache, 2 layers x 220 steps; the encoder's two GRUs
    _only(gen_counts, {"decode_attention_int8_append": 2 * LENGTH, "fused_gru": 2},
          "generate CLI on the train save path")
    out["train_cli"] = dict(seconds=secs, val_loss=[val1, val2], launches=counts,
                            generate_seconds=gen_s, generate_loaded=os.path.relpath(loaded, save),
                            generate_launches=gen_counts)
    print(f"phase 7 train CLI (default device, 2 layers, 2 epochs with --resume): "
          f"ok; {secs:.1f} s, val loss {val1:.4f} -> {val2:.4f}, checkpoints {second}; "
          f"generate CLI (default device) on its --save_path: {len(lines)} samples in "
          f"{gen_s:.1f} s from {os.path.relpath(loaded, save)}")


def phase_packed_cli(out, paths, tmp):
    """The pretrain CLI (2 layers), then the train CLI with --pack_sequences
    and --gpt2_ckpt on its file (2 layers; default device: the card): an
    epoch, a checkpoint, a resumed second epoch."""
    import dataclasses

    import torch

    from mmtg_tpu_torch import pretrain
    from mmtg_tpu_torch import train as cli

    mcfg, dcfg = model_configs()
    mcfg = dataclasses.replace(mcfg, gpt2=dataclasses.replace(mcfg.gpt2, n_layer=2))
    corpus = os.path.join(tmp, "lyrics.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write("\n".join(["青山一道同云雨", "明月何曾是两乡", "海内存知己",
                           "天涯若比邻"] * 64))
    phase1 = os.path.join(tmp, "phase1")
    _reset_counts()
    t0 = time.perf_counter()
    pretrain.main(["--corpus", corpus, "--vocab_path", paths["vocab"],
                   "--save_path", phase1, "--batch_size", "16", "--seq_len", "128",
                   "--epochs", "2", "--log_interval", "1"], cfg=mcfg.gpt2)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre = _counts()
    check(os.listdir(phase1) == ["pytorch_model.bin"], f"pretrain CLI wrote {os.listdir(phase1)}")
    steps = pre["mha_train_packed_bwd"] // 2
    _only(pre, {"mha_train_packed_fwd": 2 * steps, "mha_train_packed_bwd": 2 * steps},
          "pretrain CLI")
    check(steps >= 2, f"pretrain CLI took {steps} steps")

    save = os.path.join(tmp, "ckpt_packed")
    args = ["--train_data_path", paths["train"], "--val_data_path", paths["val"],
            "--vocab_path", paths["vocab"], "--token_emb_path", paths["emb"],
            "--batch_size", "8", "--val_batch_size", "8", "--curriculums", "0,0",
            "--alpha", "0.2", "--lr", "1e-4", "--val_interval_ratio", "1.0",
            "--log_interval", "1", "--save_model", "--save_path", save,
            "--pack_sequences", "--pack_rows", "8", "--gpt2_ckpt", phase1]
    _reset_counts()
    t0 = time.perf_counter()
    val1 = cli.main(args + ["--epochs", "1"], mcfg=mcfg, dcfg=dcfg)
    state_dir = os.path.join(save, "train_state")
    first = sorted(os.listdir(state_dir))
    check(len(first) == 1, f"packed train CLI checkpoints: {first}")
    val2 = cli.main(args + ["--epochs", "2", "--resume"], mcfg=mcfg, dcfg=dcfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    second = sorted(os.listdir(state_dir))
    check(len(second) > 1 and second[0] == first[0],
          f"packed train CLI checkpoints after --resume: {second}")
    check(val1 == val1 and val2 == val2 and abs(val1) < 1e6 and abs(val2) < 1e6,
          f"packed train CLI: val loss not finite ({val1}, {val2})")
    counts = _counts()
    # train steps go through the segment kernel (2 layers, forward + remat
    # forward + backward); eval stays unpacked: forwards of mha_train_packed
    n = counts["mha_train_packed_seg_bwd"] // 2
    _only(counts, {"mha_train_packed_seg_fwd": 4 * n, "mha_train_packed_seg_bwd": 2 * n,
                   "mha_train_packed_fwd": counts["mha_train_packed_fwd"]},
          "packed train CLI")
    check(n >= 2 and counts["mha_train_packed_fwd"] > 0,
          f"packed train CLI: launch counts {counts}")
    out["packed_cli"] = dict(pretrain_seconds=pre_s, pretrain_steps=steps,
                             seconds=secs, val_loss=[val1, val2], launches=counts)
    print(f"phase 10 pretrain CLI (2 layers, {steps} steps, {pre_s:.1f} s) -> "
          f"--gpt2_ckpt; train CLI --pack_sequences (default device, 2 layers, 2 "
          f"epochs with --resume): ok; {secs:.1f} s, {n} packed steps, val loss "
          f"{val1:.4f} -> {val2:.4f}, checkpoints {second}")


CHANNEL_KINDS = ("LSTM", "RNN", "TRM")
CHANNEL_TRAIN_STEPS = 2
ENGLISH_CORPUS = [
    "city lights are calling out my name tonight",
    "we dance until the morning sun comes up",
    "every heartbeat echoes down the empty street",
    "hold me closer while the music plays",
    "summer rain keeps falling on my mind",
    "chasing shadows through the neon glow",
    "your voice is like a melody I know",
    "we were young and running with the wind",
    "golden hours fade into the night",
    "take my hand and never let it go",
]
ENGLISH_TRAIN_STEPS = 3
FRAMING_ROWS = 4096  # rows whose token columns phase 18 frames both ways


def _to_dtype(tree, dtype):
    """The floating tensors of a batch or table dict cast to ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def _delta(before, what, expected):
    """The launches since ``before``, checked against ``expected`` (every
    other kernel 0); returns (the new counts, the launches)."""
    now = _counts()
    got = {k: now[k] - before[k] for k in now}
    _only(got, expected, what)
    return now, got


def phase_channels(out, gpu):
    """The LSTM, RNN and TRM encoder channels at full width: generate at
    B=64 (bf16, int8 cache; no fused_gru launch: it is for GRU channels),
    teacher-forced f32 logits through the kernels vs the plain versions, and
    bf16 train steps at B=64 (dropout and remat on)."""
    import dataclasses

    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate, teacher_forced_decode_logits
    from mmtg_tpu_torch.params import tree_to

    t_phase = time.perf_counter()
    base_mcfg, dcfg = model_configs()
    L = base_mcfg.gpt2.n_layer
    train_batch = _train_batch(64, dcfg, 8)
    tokens = _framed_tokens(8, TF_STEPS, 3)
    steps = L * LENGTH
    res, lines = {}, []
    _reset_counts()  # ---- this path starts here ------------------------------
    before = _counts()
    for i, kind in enumerate(CHANNEL_KINDS):
        mcfg = dataclasses.replace(
            base_mcfg, image=dataclasses.replace(base_mcfg.image, type=kind),
            text=dataclasses.replace(base_mcfg.text, type=kind))
        _, _, params, const, make_batch = _full_width_inputs(torch.float32, 40 + i,
                                                             mcfg, dcfg)
        p16, c16 = tree_to(params, DEVICE, torch.bfloat16), _to_dtype(const, torch.bfloat16)
        batch = make_batch(64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(p16, c16, mcfg, dcfg, GenerateConfig(cache_dtype="int8"),
                        _to_dtype(batch, torch.bfloat16),
                        torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        before, got = _delta(before, f"{kind} generate",
                             {"decode_attention_int8_append": steps})
        _check_tokens(toks, mcfg, dcfg, f"{kind} generate")
        del p16, c16

        small = {k: v[:8] for k, v in batch.items()}
        gcfg = GenerateConfig(cache_dtype="int8")
        a = teacher_forced_decode_logits(params, const, mcfg, dcfg, gcfg, small,
                                         tokens, use_kernels=True)
        b = teacher_forced_decode_logits(params, const, mcfg, dcfg, gcfg, small,
                                         tokens, use_kernels=False)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a).all()), f"{kind} teacher-forced: non-finite")
        tf_err = (a - b).abs().max().item()
        check(tf_err <= TEACHER_FORCED_TOL["int8"], f"{kind} teacher-forced f32 "
              f"logits, kernels vs plain: {tf_err:.3g} > {TEACHER_FORCED_TOL['int8']}")
        # the prefill takes START, then one cached step a later token
        before, _ = _delta(before, f"{kind} teacher-forced",
                           {"decode_attention_int8_append": L * (TF_STEPS - 1)})
        del a, b

        state, step = _train_state(params, mcfg, dcfg)
        state, r = _timed_steps(step, state, const, [train_batch], 1,
                                CHANNEL_TRAIN_STEPS)
        check(all(v == v and abs(v) < 1e6 for v in r["losses"]),
              f"{kind} train: loss not finite {r['losses']}")
        # the warm-up step, then the timed ones (their counts restart at 0)
        _only(r["launches"], {"mha_train_packed_fwd": 2 * L * CHANNEL_TRAIN_STEPS,
                              "mha_train_packed_bwd": L * CHANNEL_TRAIN_STEPS},
              f"{kind} train")
        before = _counts()
        res[kind] = dict(generate_wall_s=gen_s, generate_tok_per_s=64 * LENGTH / gen_s,
                         generate_launches=got, teacher_forced_max_abs=tf_err,
                         train_step_ms=r["step_ms"], train_losses=r["losses"],
                         train_launches=r["launches"])
        lines.append(f"{kind}: generate B=64 {gen_s:.3f} s ({64 * LENGTH / gen_s:.1f} "
                     f"tok/s, {steps} int8 appends, 0 fused_gru), teacher-forced "
                     f"{tf_err:.3g}, train step {r['step_ms']:.1f} ms loss "
                     f"{r['losses'][-1]:.4f}")
        del state, step, params, const
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    out["channels"] = dict(wall_s=wall, **res)
    print(f"phase 15 encoder channels LSTM / RNN / TRM (full width; generate bf16 "
          f"B=64 int8 cache, teacher-forced f32 B=8 kernels vs plain <= "
          f"{TEACHER_FORCED_TOL['int8']}, {CHANNEL_TRAIN_STEPS} bf16 train steps B=64): "
          f"ok; wall {wall:.1f} s on {gpu}; " + "; ".join(lines))


def phase_forward_infer(out, gpu):
    """mmtg_forward_infer at full width, f32, B=8, both type-id schemes: the
    train-attention kernel's forward vs attn_impl="plain", and the logits at
    the target positions vs the cached decode's teacher-forced logits."""
    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import teacher_forced_decode_logits
    from mmtg_tpu_torch.models.mmtg import mmtg_forward_infer

    t_phase = time.perf_counter()
    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.float32, 2)
    L, P = mcfg.gpt2.n_layer, dcfg.topic_prompt_length
    tokens = _framed_tokens(8, TF_STEPS, 3)
    batch = dict(make_batch(8), targets=tokens)
    res = {}
    for scheme in ("train", "reference_infer"):
        _reset_counts()  # ---- this path starts here --------------------------
        with torch.no_grad():
            a = mmtg_forward_infer(params, const, mcfg, dcfg, batch, scheme).logits
        torch.cuda.synchronize()
        _only(_counts(), {"mha_train_packed_fwd": L}, f"forward_infer {scheme}")
        with torch.no_grad():
            b = mmtg_forward_infer(params, const, mcfg, dcfg, batch, scheme,
                                   attn_impl="plain").logits
        tf = teacher_forced_decode_logits(
            params, const, mcfg, dcfg,
            GenerateConfig(cache_dtype="model", type_id_scheme=scheme),
            batch, tokens, use_kernels=True)
        torch.cuda.synchronize()
        check(a.shape == (8, P + TF_STEPS, mcfg.gpt2.vocab_size)
              and bool(torch.isfinite(a).all()), f"forward_infer {scheme}: logits")
        plain_err = (a - b).abs().max().item()
        cached_err = (a[:, P:] - tf).abs().max().item()
        check(plain_err <= INFER_TOL, f"forward_infer {scheme}: kernel vs plain "
              f"{plain_err:.3g} > {INFER_TOL}")
        check(cached_err <= TEACHER_FORCED_TOL["model"], f"forward_infer {scheme}: "
              f"vs the cached decode {cached_err:.3g} > {TEACHER_FORCED_TOL['model']}")
        res[scheme] = dict(kernel_vs_plain=plain_err, vs_cached_decode=cached_err)
    wall = time.perf_counter() - t_phase
    out["forward_infer"] = dict(wall_s=wall, **res)
    print(f"phase 16 mmtg_forward_infer (full width, f32, B=8, {TF_STEPS} target "
          f"tokens, {L} forward launches of mha_train_packed): ok; wall {wall:.1f} s "
          f"on {gpu}; " + "; ".join(
              f"{k}: kernel vs plain {v['kernel_vs_plain']:.3g} (<= {INFER_TOL}), vs "
              f"cached decode {v['vs_cached_decode']:.3g} (<= "
              f"{TEACHER_FORCED_TOL['model']})" for k, v in res.items()))


def _english_fixtures(tmp, clip_dim):
    """A byte-level BPE vocab trained on an English corpus, English records
    with CLIP embeddings of ``clip_dim``, a CLIP table over the vocab."""
    import numpy as np

    from mmtg_tpu_torch.bpe import train_bpe
    from mmtg_tpu_torch.data import make_synthetic_records

    vocab = os.path.join(tmp, "bpe_vocab")
    tok = train_bpe(ENGLISH_CORPUS, vocab_size=600)
    tok.save(vocab)
    rng = np.random.default_rng(3)
    paths = {"vocab": vocab}
    for name, n in (("train", 64), ("val", 8), ("test", 2)):
        records = make_synthetic_records(n, rng, emb_size=clip_dim,
                                         lyrics_pool=ENGLISH_CORPUS, topic="city")
        if name == "test":
            for r in records:
                r.pop("rating")
        paths[name] = os.path.join(tmp, f"en_{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(records, f)
    paths["emb"] = os.path.join(tmp, "clip_emb.pkl")
    with open(paths["emb"], "wb") as f:
        pickle.dump({i: rng.standard_normal(clip_dim).astype(np.float32)
                     for i in range(len(tok))}, f)
    paths["ref"] = os.path.join(tmp, "en_ref.txt")
    with open(paths["ref"], "w", encoding="utf-8") as f:
        f.write("\n".join(["，".join(ENGLISH_CORPUS[:2])] * 2) + "\n")
    return paths


def phase_english(out, gpu, tmp):
    """The English variant: at full width (CLIP 512, vocab 50257,
    n_positions 1024) bf16 train steps at B=64 and generate at B=64 (int8
    cache, fused_gru at input width 512) and B=1 (bf16 cache); then, at depth
    2, the train CLI from a model.safetensors snapshot with a profiler trace,
    the generate CLI on its save path and eval on the output."""
    import dataclasses

    import torch

    from mmtg_tpu_torch import eval as teval
    from mmtg_tpu_torch import generate as gen_cli
    from mmtg_tpu_torch import train as train_cli
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.checkpoint import write_safetensors
    from mmtg_tpu_torch.configs import GenerateConfig, english_variant
    from mmtg_tpu_torch.decoding import generate
    from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2
    from mmtg_tpu_torch.params import init_gpt2_params, tree_to

    t_phase = time.perf_counter()
    mcfg, dcfg = english_variant(clip_dim=512, gpt2_vocab=50257)
    L, V = mcfg.gpt2.n_layer, mcfg.gpt2.vocab_size
    _, _, params, const, make_batch = _full_width_inputs(torch.float32, 50, mcfg, dcfg)
    # train: synthetic rows framed by the dataset code, content ids drawn over
    # the whole vocab
    batch = _train_batch(64, dcfg, 12)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for k in ("topic_ids", "targets"):
        content = batch[k] >= 103
        batch[k] = torch.where(content, torch.randint(
            103, V, batch[k].shape, generator=gen, device=DEVICE,
            dtype=batch[k].dtype), batch[k])
    state, step = _train_state(params, mcfg, dcfg)
    state, r = _timed_steps(step, state, const, [batch], 1, ENGLISH_TRAIN_STEPS)
    _check_trained("english train", r, state)
    _only(r["launches"], {"mha_train_packed_fwd": 2 * L * ENGLISH_TRAIN_STEPS,
                          "mha_train_packed_bwd": L * ENGLISH_TRAIN_STEPS},
          "english train")
    del state, step, batch
    torch.cuda.empty_cache()

    p16, c16 = tree_to(params, DEVICE, torch.bfloat16), _to_dtype(const, torch.bfloat16)
    del params
    _reset_counts()  # ---- the generate path starts here ----------------------
    before, gen_res = _counts(), {}
    for what, b, gcfg, expected in (
            ("b64 int8 cache", 64, GenerateConfig(cache_dtype="int8"),
             {"decode_attention_int8_append": L * LENGTH, "fused_gru": 2}),
            ("b1 bf16 cache", 1, GenerateConfig(cache_dtype="model"),
             {"decode_attention_fp_append": L * LENGTH, "fused_gru": 2})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(p16, c16, mcfg, dcfg, gcfg, _to_dtype(make_batch(b), torch.bfloat16),
                        torch.Generator(device=DEVICE).manual_seed(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        before, got = _delta(before, f"english generate {what}", expected)
        _check_tokens(toks, mcfg, dcfg, f"english generate {what}")
        gen_res[what] = dict(wall_s=wall, tok_per_s=b * LENGTH / wall, launches=got)
    del p16, c16
    torch.cuda.empty_cache()

    # the CLIs at depth 2 (default device: the card)
    clip = str(dcfg.wenlan_emb_size)
    paths = _english_fixtures(tmp, dcfg.wenlan_emb_size)
    tok = load_tokenizer(paths["vocab"])
    check(tok.native is not None, "english: the native BPE encoder did not load")
    slow = load_tokenizer(paths["vocab"], use_native=False)
    for line in ENGLISH_CORPUS:
        check(tok.encode(line) == slow.encode(line),
              f"english: native BPE ids differ from Python's on {line!r}")
    cli_mcfg, cli_dcfg = english_variant(clip_dim=dcfg.wenlan_emb_size,
                                         gpt2_vocab=len(tok))
    cli_mcfg = dataclasses.replace(cli_mcfg, gpt2=dataclasses.replace(
        cli_mcfg.gpt2, n_layer=2))
    snapshot = os.path.join(tmp, "gpt2_snapshot")
    os.makedirs(snapshot)
    write_safetensors(os.path.join(snapshot, "model.safetensors"), export_hf_gpt2(
        init_gpt2_params(cli_mcfg.gpt2, seed=6), cli_mcfg.gpt2))
    save, trace = os.path.join(tmp, "en_ckpt"), os.path.join(tmp, "en_trace")
    _reset_counts()
    t0 = time.perf_counter()
    val = train_cli.main(
        ["--variant", "english", "--clip_dim", clip,
         "--train_data_path", paths["train"], "--val_data_path", paths["val"],
         "--vocab_path", paths["vocab"], "--token_emb_path", paths["emb"],
         "--batch_size", "2", "--val_batch_size", "8", "--epochs", "1",
         "--curriculums", "0,0", "--alpha", "0.2", "--lr", "1e-4",
         "--val_interval_ratio", "1.0", "--log_interval", "8",
         "--gpt2_ckpt", snapshot, "--profile_dir", trace,
         "--save_model", "--save_path", save], mcfg=cli_mcfg, dcfg=cli_dcfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts()
    check(val == val and abs(val) < 1e6, f"english train CLI: val loss {val}")
    check(counts["mha_train_packed_bwd"] == 2 * 32
          and counts["mha_train_packed_fwd"] > 2 * 2 * 32,
          f"english train CLI: launch counts {counts}")
    traces = [os.path.join(trace, f) for f in os.listdir(trace)]
    check(len(traces) == 1 and os.path.getsize(traces[0]) > 0,
          f"english train CLI: --profile_dir wrote {traces}")
    trace_mb = os.path.getsize(traces[0]) / 1e6
    samples = os.path.join(tmp, "en_samples.txt")
    _reset_counts()
    t0 = time.perf_counter()
    gen_cli.main(["--variant", "english", "--clip_dim", clip,
                  "--data_path", paths["test"], "--model_path", save,
                  "--tokenizer_path", paths["vocab"], "--token_emb_path", paths["emb"],
                  "--batch_size", "4", "--n_samples", "2", "--save_samples",
                  "--save_samples_path", samples], mcfg=cli_mcfg, dcfg=cli_dcfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    _only(_counts(), {"decode_attention_int8_append": 2 * LENGTH, "fused_gru": 2},
          "english generate CLI")
    with open(samples, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == 4 and all(ln.strip() for ln in lines),
          f"english generate CLI wrote {lines}")
    check(not any(c in "".join(lines) for c in "ĠĊ"),
          "english generate CLI: byte-alphabet symbols in the output")
    metrics = teval.evaluate_files(samples, paths["ref"])
    wall = time.perf_counter() - t_phase
    out["english"] = dict(wall_s=wall, train=r, generate=gen_res,
                          train_cli_s=train_s, train_cli_val_loss=val,
                          trace_mb=trace_mb, generate_cli_s=gen_s, metrics=metrics)
    print(f"phase 17 English variant (CLIP 512, vocab {V}, n_positions "
          f"{mcfg.gpt2.n_positions}): ok; wall {wall:.1f} s on {gpu}; train B=64 "
          f"{r['step_ms']:.1f} ms a step, loss {r['losses'][0]:.4f} -> "
          f"{r['losses'][-1]:.4f}; " + "; ".join(
              f"generate {k} {v['wall_s']:.3f} s ({v['tok_per_s']:.1f} tok/s)"
              for k, v in gen_res.items())
          + f"; CLIs at depth 2: train from model.safetensors 32 steps {train_s:.1f} s "
          f"(trace {trace_mb:.1f} MB), generate {gen_s:.1f} s, distinct-1 "
          f"{metrics['distinct1']:.3f}, BLEU-1 {metrics['bleu1']:.3f}; first: "
          f"{lines[0][:50]!r}")


def phase_predict(out, gpu, paths, tmp):
    """The REPL (default device) on phase 7's save path, fed two indices and
    q with the swap probe; then MMTGDataset's token columns through the
    native row packer against the Python framing on phase 7's records."""
    import contextlib
    import dataclasses
    import io

    import numpy as np

    from mmtg_tpu_torch import predict
    from mmtg_tpu_torch.data import MMTGDataset, encode_lyrics, encode_topic
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    t_phase = time.perf_counter()
    mcfg, dcfg = model_configs()
    mcfg = dataclasses.replace(mcfg, gpt2=dataclasses.replace(mcfg.gpt2, n_layer=2))
    n_samples = 2
    stdin, stdout = sys.stdin, io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        sys.stdin = io.StringIO("0\n1\nq\n")
        with contextlib.redirect_stdout(stdout):
            predict.main(["--data_path", paths["test"],
                          "--model_path", os.path.join(tmp, "ckpt"),
                          "--tokenizer_path", paths["vocab"],
                          "--token_emb_path", paths["emb"],
                          "--n_samples", str(n_samples), "--swap_probe"],
                         mcfg=mcfg, dcfg=dcfg)
    finally:
        sys.stdin = stdin
    repl_s = time.perf_counter() - t0
    text = stdout.getvalue()
    lyrics = [ln for ln in text.splitlines() if ln.startswith("  [")]
    check(len(lyrics) == 2 * 2 * n_samples and all(len(ln) > 12 for ln in lyrics)
          and text.count("swap probe") == 2, f"predict printed {text!r}")
    calls = 2 * 2  # two indices, each plain and swapped
    _only(_counts(), {"decode_attention_int8_append": calls * 2 * LENGTH,
                      "fused_gru": 2 * calls}, "predict")

    native = WordPieceTokenizer.from_file(paths["vocab"])
    check(native.native is not None, "the native WordPiece tokenizer did not load")
    python = WordPieceTokenizer.from_file(paths["vocab"], use_native=False)
    a = MMTGDataset(paths["train"], native, dcfg, if_train=True).arrays()
    b = MMTGDataset(paths["train"], python, dcfg, if_train=True).arrays()
    keys = ("topic_ids", "tpw_attention_mask", "tpw_type_ids", "targets",
            "attention_mask", "type_ids")
    for k in keys:
        check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
              f"native pack_rows: column {k} differs from the Python framing")
    # the token columns' rate (rows a second), the records repeated to a
    # corpus where the framing, not the call, takes the time
    with open(paths["train"], "rb") as f:
        records = pickle.load(f)
    records = (records * (FRAMING_ROWS // len(records) + 1))[:FRAMING_ROWS]
    t0 = time.perf_counter()
    cols = native.native.pack_rows(
        [r["topic"] for r in records], [list(r["lyrics"]) for r in records],
        topic_len=dcfg.topic_prompt_length, max_sent=dcfg.max_sent_length,
        pad_id=python.pad_token_id, start_id=python.convert_tokens_to_ids("[#START#]"),
        eos_id=python.convert_tokens_to_ids("[#EOS#]"), sep_id=python.sep_token_id)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    framed = [encode_lyrics(python, r["lyrics"], dcfg)[0] for r in records]
    topics = [encode_topic(python, r["topic"], dcfg)[0] for r in records]
    python_s = time.perf_counter() - t0
    check(np.array_equal(cols["targets"], np.asarray(framed, np.int32))
          and np.array_equal(cols["topic_ids"], np.asarray(topics, np.int32)),
          f"native pack_rows over {FRAMING_ROWS} rows differs from the Python framing")
    rates = dict(native_rows_per_s=FRAMING_ROWS / native_s,
                 python_rows_per_s=FRAMING_ROWS / python_s)
    wall = time.perf_counter() - t_phase
    out["predict"] = dict(wall_s=wall, repl_s=repl_s, lines=len(lyrics),
                          dataset_rows=len(a["targets"]), framing_rows=FRAMING_ROWS,
                          **rates)
    print(f"phase 18 predict REPL (default device, 2 layers, indices 0 and 1 with "
          f"the swap probe, {n_samples} samples each): ok; {len(lyrics)} lines in "
          f"{repl_s:.1f} s; native pack_rows columns equal the Python framing's on "
          f"{len(a['targets'])} rows; token columns of {FRAMING_ROWS} rows: native "
          f"{rates['native_rows_per_s']:.0f} rows/s, Python "
          f"{rates['python_rows_per_s']:.0f} rows/s; wall {wall:.1f} s on {gpu}; "
          f"first: {lyrics[0][:50]!r}")


# (name, source, the TPU kernel it replaces, the phase whose run counts its
# launches, the key of its phase-2 result at its main path's shape)
_TA = "mmtg_tpu_torch/csrc/train_attention.cu"
_DA = "mmtg_tpu_torch/csrc/decode_attention.cu"
_JDA = "mmtg_tpu/ops/decode_attention.py"
KERNELS = [
    ("decode_attention_int8_append", _DA, f"{_JDA}:169", "generate", ()),
    ("decode_attention_fp_append", _DA, f"{_JDA}:137", "generate", ()),
    ("fused_gru", "mmtg_tpu_torch/csrc/fused_gru.cu",
     "mmtg_tpu/ops/fused_gru.py:60", "generate", ()),
    # the read-only kernels' path is the oracle cross-check (phase 11)
    ("decode_attention", _DA, f"{_JDA}:50", "oracle", ()),
    ("decode_attention_int8", _DA, f"{_JDA}:78", "oracle", ()),
    ("decode_attention_int4", _DA, f"{_JDA}:106", "oracle", ()),
    ("decode_attention_int4_append", _DA, f"{_JDA}:211", "generate_serving", ()),
    ("decode_attention_int8_append_merged", _DA, f"{_JDA}:243", "generate_serving", ()),
    ("mha_train", _TA, "mmtg_tpu/ops/train_attention.py:283", "train_head_major",
     (TRAIN_BATCHES[-1],)),
    ("mha_train_packed", _TA, "mmtg_tpu/ops/train_attention.py:723", "train",
     (TRAIN_BATCHES[-1],)),
    ("mha_train_packed_seg", _TA, "mmtg_tpu/ops/train_attention.py:694",
     "train_packed", (PACK_ROWS,)),
    ("decode_block_fused", "mmtg_tpu_torch/csrc/decode_block_fused.cu",
     "mmtg_tpu/ops/decode_megakernel.py:360", "generate_serving", ()),
]


def _write_json(path, out):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step (torch.profiler)")
    ap.add_argument("--build-serial", action="store_true",
                    help="also time a single-process build of the kernels")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (the kernels against their plain "
                         "versions): no main path, no kernels line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mmtg_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    phase_build(out, args.build_serial)
    gpu = gpu_line()
    out["gpu"] = gpu
    results = phase_kernels(out)
    if args.kernels_only:
        _write_json(args.json, out)
        print(f"gpu: {gpu}")
        return 0
    # each main path's run, the counts set to 0 before it and read after it
    launches = {"generate": phase_generate(out, gpu)}
    phase_teacher_forced(out)
    launches["oracle"] = phase_oracle(out)
    launches["generate_serving"] = phase_generate_serving(out, gpu)
    launches["stream"] = phase_stream(out, gpu)
    mcfg, dcfg = model_configs()
    tmp = tempfile.mkdtemp(prefix="mmtg_chip_smoke_")
    try:
        paths = _cli_fixtures(tmp, dcfg)
        model = _reference_checkpoint(tmp)
        phase_cli(out, paths, tmp, model)
        launches["serve"] = phase_serve(out, gpu, paths, model)
        os.remove(model)
        launches["train"] = phase_train(out, gpu, args.profile)
        phase_train_cli(out, paths, tmp)
        launches["train_packed"] = phase_train_packed(out, gpu, args.profile)
        launches["train_head_major"] = phase_train_head_major(out, gpu)
        phase_packed_cli(out, paths, tmp)
        phase_channels(out, gpu)
        phase_forward_infer(out, gpu)
        phase_english(out, gpu, tmp)
        phase_predict(out, gpu, paths, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, source, replaces, path, shape in KERNELS:
        r = results[(name, "bfloat16", *shape)]
        f32 = results[(name, "float32", *shape)]
        counts = launches[path]
        if name in TRAIN_FNS:
            # forward + backward of one layer at the path's shape
            n = counts[f"{name}_fwd"] + counts[f"{name}_bwd"]
            extra = dict(
                fwd_launches=counts[f"{name}_fwd"], bwd_launches=counts[f"{name}_bwd"],
                **{k: r[k] for k in ("kernel_fwd", "kernel_bwd", "plain_fwd",
                                     "plain_bwd", "library_fwd", "library_bwd")},
                fwd_bound_ms=r["fwd_bound"]["bound_ms"],
                bwd_bound_ms=r["bwd_bound"]["bound_ms"])
        else:
            n, extra = counts[name], {}
            if name == "decode_block_fused":
                # also driven by the service (phase 14); no one PyTorch call
                # computes a decode step: the port's per-layer step beside it
                extra = dict(serve_launches=launches["serve"][name],
                             per_layer_step_ms=r["per_layer_step_ms"],
                             other_batches={
                                 f"B{b}": {k: results[(name, "bfloat16", f"B{b}")][k]
                                           for k in ("ms", "per_layer_step_ms", "bound_ms")}
                                 for b in OTHER_BATCHES})
        check(n > 0, f"{name} was not launched on its path ({path})")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dtype="bfloat16",
            f32_max_abs_err=f32["max_abs_err"], **extra))
    out["kernels"] = kernels
    _write_json(args.json, out)
    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
