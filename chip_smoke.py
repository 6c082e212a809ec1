#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mmtg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for
the numbers in PERF.md):

    python3 chip_smoke.py [--json results.json] [--profile] [--build-serial]

Phases, each printing one line (any failure raises and exits non-zero):
  1. look up the card's published peaks (memory rate, bf16 and f32 operation
     rates) in mmtg_tpu_torch/utils/roofline.py by its name (a card the
     tables do not know fails here, before anything is timed), build the
     CUDA kernels from mmtg_tpu_torch/csrc/ (nvcc, sm_90a) and print the
     build time and the card's name and power limit;
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
     larger of bytes / the card's memory rate and operations / its peak
     rate for their type, phase 1's peaks) is computed; then
     the same for every decode wrapper (bf16), the GRU and the whole-step
     kernel (both types) at B=1 (the p50 path) and B=512, the whole-step
     kernel's ptxas line and launch plan beside its times;
  3. the generation path, decoding.generate, at the full model width
     (12-layer 768-d GPT-2, vocab 13317, 2048-d WenLan, random seeded
     weights) in bf16: B=64 with the int8 cache, then B=8 and B=1 with the
     bf16 cache; the kernel launch counters prove the kernels ran; the B=1
     call's median wall over 5 calls is the p50 latency; each call's (and
     the p50's) decode hbm_util (utils/roofline.py: the modeled bytes of
     the call's batch, length and resolved dtypes / wall / the card's
     memory rate), which must lie in (0, 1.05];
  4. teacher-forced logits through the kernels vs through the plain
     versions, full width, f32: fp, int8, int4 and merged caches, and the
     whole-step kernel;
  5. the generate CLI on a synthetic .pth checkpoint;
  6. the train path, train.make_train_step, at full width: bf16 compute /
     f32 masters, B=64, dropout on, remat ("auto"), 1 warm-up + 5 timed steps on
     one repeated batch (loss finite and falling, launch counts asserted;
     the step's mfu and hw_flops_util from utils/roofline.py, each in
     (0, 1.05]), then B=8 in f32 without dropout: loss and every gradient leaf through
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
     each call's hbm_util as in phase 3;
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
 19. the sharded serving path over torch.distributed, full width, B=64, 220
     tokens, ranks started as child processes by `python -m
     torch.distributed.run` (each launch with its own time limit; a failed
     rank fails the phase) on the cards there are (the backend by the rule
     of parallel/mesh.py: gloo when ranks share a card): on the meshes
     (2, 1), (1, 2) and (2, 2), generate_sharded in bf16 and f32 (wall,
     launches a rank, all-reduces a step and their time, TP ranks' tokens
     checked equal), an int8 cache and (DP-only) the whole-step kernel on
     two sentence frames, generate_stream_sharded = generate_sharded token
     for token, f32 step logits of the sharded decode on forced tokens
     within 1e-4 of the single-device step, the share of f32 rows equal to
     single-device generate (reported), and per rank the decode kernels
     and the GRU at the shard shapes against their plain versions; then
     `python -m mmtg_tpu_torch.serve` on a (2, 2) mesh under torchrun (f32,
     buckets 4,8): a window of three one-shot and one streamed request over
     HTTP, /reload, one more request, each held against generate_sharded on
     the mesh, SIGTERM to rank 0 and every rank exiting 0.
 20. training over the mesh under torchrun: data, tensor and pipeline
     parallel and ZeRO-1 train steps against the single-card step, then the
     train CLI on a mesh (see phase_mesh_train); on a TP mesh the
     collectives a step under the policy "auto" resolves to beside "full"'s.
 21. the remat policies of the train step at full width, bf16 compute / f32
     masters, dropout on: full, save_qkv_ctx, save_ctx_fc1, save_all and no
     remat, 1 warm-up + 3 timed steps each on the unpacked step at B=64 and
     B=256, the head-major step at B=64 and the packed step on 32 rows of
     512 (step time, samples/s, peak memory beside the bytes each policy was
     predicted to keep; mfu and hw_flops_util of each unpacked run as in
     phase 6; the attention launches asserted: the forward twice a
     layer under full, once otherwise; peak memory at B=256 ordered full <
     save_qkv_ctx < save_ctx_fc1 < save_all <= no remat); then f32 with
     dropout at B=8 and on 4 packed rows: each policy's loss and every
     gradient leaf within 1e-6 (of the largest leaf) of no remat's.
 22. the quality loop (mmtg_tpu_torch.quality_loop) at full width, bf16
     compute / f32 masters, dropout on: the curriculum [1,3] over 5 epochs
     through the train CLI (512 samples, batch 32, stage 1 at 64), then the
     generate CLI on its save path for each mode (fp, int8, int4 caches,
     int8 cache + int8 weights, approx top-k) and seed (7, 8, 9), 8 lines a
     call, the fp mode once more with seed 7 (the same lines), BLEU-2 /
     distinct-2 per mode, each mode against the fp decode and fp against fp
     across seeds; then the packing A/B (parity against --pack_sequences
     --pack_row_len 256, 3 epochs). The val loss must fall across the stage
     changes; every train run's and generate call's launch counts are
     asserted.
(Phases 11-14 run after phase 4, phase 21 after phase 9, phases 15-18 after
phase 10, then phases 22, 19 and 20.)
Where a train step runs with remat and the policy "auto" (phases 6-10, 15,
17, 20), its attention launches are asserted for the policy "auto" resolves
to (train._resolve_remat_policy): the kept qkv and context at these batches,
a forward and a backward a layer.
It then prints its total time, the card's name and power limit, the
kernels' JSON line (with each mesh kernel's launches a rank on phase 19's
meshes) and, last, the device JSON line.
--profile adds a torch.profiler kernel-time split of one B=64 train step
and of one packed train step;
--build-serial also times one nvcc process over all sources beside the
parallel build; --kernels-only stops after phase 2 (to time another
checkout's kernels with this script's measurements); --mesh-train-only runs
phase 1 and phase 20 alone, --quality-only phase 1 and phase 22. Without a
CUDA device it exits non-zero and prints no result.
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
SHARE_MAX = 1.05  # a roofline share above this means a wrong count or wall
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


def device_kind() -> str:
    import torch

    return torch.cuda.get_device_name()


def card_peaks(kind: str) -> tuple:
    """(memory bytes/s, {dtype name: operations/s}) of the card named
    ``kind``: the published figures in mmtg_tpu_torch/utils/roofline.py.
    A card the tables do not know raises ValueError naming it."""
    from mmtg_tpu_torch.utils import roofline

    return (roofline.peak_hbm_gbps(kind) * 1e9,
            {"bfloat16": roofline.peak_bf16_tflops(kind) * 1e12,
             "float32": roofline.peak_f32_tflops(kind) * 1e12})


def bound(nbytes: float, ops: float, dname: str) -> dict:
    """The least time the card could take: each input read and each output
    written once at the memory rate, the operations at the peak rate of
    their type; the larger of the two."""
    mem_rate, op_rates = card_peaks(device_kind())
    by_bytes = nbytes / mem_rate * 1e3
    by_ops = ops / op_rates[dname] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=nbytes, operations=ops)


def check_shares(what: str, r: dict, keys) -> dict:
    """Fails unless each roofline share ``r[key]`` lies in (0, SHARE_MAX]."""
    for k in keys:
        check(0.0 < r[k] <= SHARE_MAX, f"{what}: {k} {r[k]} is outside (0, "
              f"{SHARE_MAX}]: the modeled count or the measured wall is wrong")
    return r


def decode_share(what, gcfg, mcfg, dcfg, b, wall_s, dtype) -> dict:
    """roofline.decode_hbm_util of one generate call of ``b`` rows, with the
    length, cache and weight dtypes the call resolved and its model dtype;
    the share checked."""
    from mmtg_tpu_torch.decoding import resolve_cache_dtype, resolve_weight_dtype
    from mmtg_tpu_torch.utils import roofline

    return check_shares(what, roofline.decode_hbm_util(
        mcfg, dcfg, b, gcfg.length, wall_s, device_kind(),
        cache_dtype=resolve_cache_dtype(gcfg, b),
        weight_dtype=resolve_weight_dtype(gcfg, b),
        model_dtype=roofline.dtype_name(dtype)), ("hbm_util",))


def train_share(what, mcfg, dcfg, b, step_ms, remat) -> dict:
    """roofline.train_mfu of one bf16 train step of ``b`` unpacked rows; the
    shares checked."""
    from mmtg_tpu_torch.utils import roofline

    return check_shares(what, roofline.train_mfu(
        mcfg, dcfg, b, step_ms / 1e3, device_kind(), remat=remat),
        ("mfu", "hw_flops_util"))


def _hbm(r: dict) -> str:
    return f"hbm_util {r['hbm_util']} ({r['achieved_gbps']} GB/s)"


def _mfu(r: dict) -> str:
    return f"mfu {r['mfu']} hw_flops_util {r['hw_flops_util']}"


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

    kind = device_kind()
    mem_rate, op_rates = card_peaks(kind)  # before anything is timed
    out["peaks"] = dict(kind=kind, memory_bytes_per_s=mem_rate,
                        operations_per_s=op_rates)
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
          f"-> {os.path.relpath(_build.library_path())}; peaks of {kind} "
          f"(mmtg_tpu_torch/utils/roofline.py): {mem_rate / 1e9:g} GB/s, bf16 "
          f"{op_rates['bfloat16'] / 1e12:g} TFLOP/s, f32 "
          f"{op_rates['float32'] / 1e12:g}; ptxas: " + " | ".join(regs))
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


def _attention_case(dtype, kind, gen, B=B_ATT, D=D):
    """q, k_new, v_new, a key mask with holes, and a cache of ``kind`` (fp /
    int8 / int4 / merged) filled everywhere, ``D`` lanes a row: (q, k_new,
    v_new, mask, caches, scales) with caches = [k, v] or [kv]."""
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


def _decode_calls(da, name, kind, append, q, k_new, v_new, mask, H=H):
    """(kernel call, plain call) of one wrapper over ``H`` heads, each taking
    (caches, scales, position, layer)."""
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


def _decode_vs_plain(results, da, name, kind, append, dtype, B, gen, H=H, D=D,
                     tag=None):
    """One decode-attention wrapper (the kernel) vs its plain version at
    batch ``B``, ``H`` heads of ``D / H`` lanes: ctx within TOL and the
    cache and scales bit for bit at every position of POSITIONS; then device
    times of the kernel, the plain version and (fp cache) one SDPA call at
    TIMED_POSITION, and the bound. Stores the result under (name, dtype) at
    B_ATT, else (name, dtype, "B<B>"), with ``tag`` appended when given."""
    import torch

    dname = str(dtype).split(".")[1]
    q, k_new, v_new, mask, base_c, base_s = _attention_case(dtype, kind, gen, B, D)
    run_kernel, run_plain = _decode_calls(da, name, kind, append, q, k_new,
                                          v_new, mask, H)
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
    key += (tag,) if tag else ()
    results[key] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(nbytes, 4.0 * n_live * D, dname))
    del base_c, base_s, caches, scales
    torch.cuda.empty_cache()
    return (f"{name}[{dname} B={B} H={H} D={D}] err {err:.3g} kernel {ms:.4f} ms "
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
                        sdpa_inputs, nbytes, pairs, hd_ops, tols=TRAIN_TOL, heads=H,
                        key=None):
    """One train-attention function (kernels) vs its plain version on the
    same inputs: ctx, dqkv, dqb at rate 0 and 0.1; then device times of the
    kernels, the plain version and one SDPA call at rate 0.1, and the bound.
    ``sdpa_inputs()`` -> (q, k, v [B, H, T, hd], boolean mask); ``nbytes`` =
    (forward, backward) bytes of the function's own inputs and outputs;
    ``pairs`` = the (i, j) pairs that may attend, summed over batch and
    heads; ``hd_ops`` the head width the products run over; ``heads`` the
    head count (a TP rank's: fewer); the result is stored under ``(name,
    dtype name, key or B)``."""
    import torch

    dname = str(dtype).split(".")[1]
    seed = torch.tensor([20240229], dtype=torch.int32, device=DEVICE)
    errs = {}
    for rate in (0.0, 0.1):
        outs = []
        for f in (fn, plain):
            a = qkv.clone().requires_grad_(True)
            b = qb.clone().requires_grad_(True)
            ctx = f(a, b, mask, seed, heads, rate, scale)
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
                lambda: f(qkv, qb, mask, seed, heads, rate, scale), reps=11, warmup=2)
        a = qkv.clone().requires_grad_(True)
        b = qb.clone().requires_grad_(True)
        ctx = f(a, b, mask, seed, heads, rate, scale)
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
    results[(name, dname, B if key is None else key)] = dict(
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


def _train_launches(fn, L, steps, batch, dcfg, policy="auto", remat=True,
                    data_size=1):
    """``fn``'s launches in ``steps`` train steps of ``L`` layers: a forward and
    a backward a layer, and the forward once more in the backward when remat
    keeps no attention context (under "full", which "auto" resolves to as the
    trainer does: train._resolve_remat_policy)."""
    from mmtg_tpu_torch import train as ttrain

    policy = ttrain._resolve_remat_policy(policy, batch, None,
                                          dcfg.topic_prompt_length, data_size)
    again = remat and policy == "full"
    return {f"{fn}_fwd": (2 if again else 1) * L * steps, f"{fn}_bwd": L * steps}


def _check_tokens(toks, mcfg, dcfg, what, length=LENGTH):
    import torch

    from mmtg_tpu_torch.configs import SpecialTokens
    from mmtg_tpu_torch.ops.sampling import frame_forced_token

    check(toks.shape == (toks.shape[0], length + 1) and toks.dtype == torch.int32,
          f"{what}: tokens {tuple(toks.shape)} {toks.dtype}")
    V = mcfg.gpt2.vocab_size
    check(bool(((toks >= 0) & (toks < V)).all()), f"{what}: token id out of range")
    check(bool((toks[:, 0] == SpecialTokens().start_id).all()), f"{what}: no START")
    for i in range(length):
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
        share = decode_share(f"phase 3 {what}", gcfg, mcfg, dcfg, b, wall,
                             torch.bfloat16)
        out[f"generate_{what.replace(' ', '_')}"] = dict(
            wall_s=wall, tok_per_s=tps, launches=got, roofline=share)
        lines.append(f"{what}: {wall:.3f} s, {tps:.1f} tok/s, {_hbm(share)}, "
                     f"launches { {k: v for k, v in got.items() if v} }")
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
    share = decode_share("phase 3 b1 p50", gcfg, mcfg, dcfg, b, p50, torch.bfloat16)
    out["generate_b1_p50"] = dict(p50_s=p50, walls_s=walls, tok_per_s=LENGTH / p50,
                                  roofline=share)
    lines.append(f"b1 p50 of {P50_CALLS} calls {p50:.3f} s ({LENGTH / p50:.1f} "
                 f"tok/s, {_hbm(share)})")
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
        share = decode_share(f"phase 12 {what}", gcfg, mcfg, dcfg, 64, wall,
                             torch.bfloat16)
        res[what] = dict(wall_s=wall, tok_per_s=64 * LENGTH / wall, launches=got,
                         roofline=share)
        lines.append(f"{what}: {wall:.3f} s, {64 * LENGTH / wall:.1f} tok/s, "
                     f"{_hbm(share)}, launches {expected}")
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
    # a forward and a backward per layer and step ("auto" keeps the context
    # at B=64); nothing else
    _only(launches, _train_launches("mha_train_packed", L, STEPS, batch, dcfg),
          "train")
    r["roofline"] = train_share("phase 6 train", mcfg, dcfg, B, r["step_ms"], True)
    out["train_b64"] = r
    print(f"phase 6 train (full width, bf16 compute / f32 masters, B={B}, "
          f"dropout on, remat, {STEPS} steps, on {gpu}): ok; median step "
          f"{r['step_ms']:.1f} ms, {r['samples_per_s']:.1f} samples/s, "
          f"{_mfu(r['roofline'])}, loss "
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
    _only(launches, _train_launches("mha_train_packed_seg", L, STEPS, batches[0],
                                    dcfg), "packed train")
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
        _only(got, _train_launches("mha_train_packed_seg", L, 1, long_batches[1], dcfg),
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
    batch = _train_batch(B, dcfg, 8)
    state, r = _timed_steps(step, state, const, [batch], WARM, STEPS)
    launches = r["launches"]
    _check_trained("head-major train", r, state)
    _only(launches, _train_launches("mha_train", L, STEPS, batch, dcfg),
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


# Phase 21: the remat policies of the train step
REMAT_POLICIES = ("full", "save_qkv_ctx", "save_ctx_fc1", "save_all")
REMAT_RUNS = REMAT_POLICIES + ("no_remat",)  # the last: --no_remat
REMAT_STEPS = 3
# (cell, the attention function its layers call, rows): the unpacked step at
# B=64 and B=256 (the first B=256 train step), the head-major slab at B=64 and
# the packed step on 32 rows of 512
REMAT_CELLS = (("B64", "mha_train_packed", 64), ("B256", "mha_train_packed", 256),
               ("B64_head_major", "mha_train", 64),
               ("packed", "mha_train_packed_seg", PACK_ROWS))
REMAT_F32_TOL = 1e-6  # each leaf's max-abs difference / the largest leaf's max-abs


def remat_kept_bytes(policy, B, Tp, D, heads, n_layer, head_major=False, elt=2):
    """The bytes a policy keeps beyond "full" in a step (its prediction): a
    layer's qkv (``[B, Tp, 3D]``, or ``H·384`` lanes on the head-major slab),
    context (``D``, or ``H·128``) with the kernels' f32 row log-sum-exp
    ``[B, H, Tp]``, and fc1 (``[B, Tp, 4D]``), in the compute dtype."""
    from mmtg_tpu_torch.models.gpt2 import REMAT_POLICIES as KEPT

    q_w, c_w = (heads * 384, heads * 128) if head_major else (3 * D, D)
    per = {"qkv": B * Tp * q_w * elt,
           "attn_ctx": B * Tp * c_w * elt + B * heads * Tp * 4,
           "mlp_fc1": B * Tp * 4 * D * elt}
    return n_layer * sum(per[n] for n in KEPT[policy])


def _remat_tcfg(run, impl="auto", dtype="bfloat16"):
    from mmtg_tpu_torch.configs import TrainConfig

    return TrainConfig(dtype=dtype, remat=run != "no_remat", lr=1e-4, alpha=0.2,
                       remat_policy="full" if run == "no_remat" else run,
                       attn_impl=impl)


def _remat_f32_compare(params, const, mcfg, dcfg, batch, what):
    """f32, dropout on: each policy's loss and every gradient leaf against the
    step without remat (the same dropout seeds)."""
    import torch

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.params import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)

    def run(name):
        total, _ = ttrain.loss_and_metrics(
            params, const, mcfg, dcfg, _remat_tcfg(name, dtype="float32"), batch, 3,
            torch.Generator().manual_seed(17), False)
        grads = torch.autograd.grad(total, tree_leaves(params))
        torch.cuda.synchronize()
        return float(total.detach()), grads

    ref_loss, ref = run("no_remat")
    largest = max(g.abs().max().item() for g in ref)
    errs = {}
    for policy in REMAT_POLICIES:
        loss, grads = run(policy)
        err = max((a - b).abs().max().item() for a, b in zip(grads, ref))
        check(abs(loss - ref_loss) <= REMAT_F32_TOL * abs(ref_loss),
              f"{what} {policy}: loss {loss} vs no remat {ref_loss}")
        check(err <= REMAT_F32_TOL * largest, f"{what} {policy}: a gradient leaf "
              f"differs from no remat's by {err:.3g} > {REMAT_F32_TOL} x {largest:.3g}")
        errs[policy] = dict(loss_abs_err=abs(loss - ref_loss), grad_max_abs_err=err,
                            grad_rel_err=err / largest)
    return dict(largest_grad=largest, leaves=len(ref), policies=errs)


def phase_remat(out, gpu):
    """Phase 21: the train step under each remat policy and without remat, at
    full width (bf16 compute / f32 masters, dropout on): 1 warm-up + 3 timed
    steps a run on one repeated batch; launches, loss, peak memory; then the
    f32 gradients of each policy against no remat's."""
    import gc

    import torch

    from mmtg_tpu_torch import train as ttrain

    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7)
    g = mcfg.gpt2
    L = g.n_layer
    _, np_packed = packed_batches(dcfg, 24 * PACK_ROWS, PACK_ROWS, 11)
    to_dev = lambda b: {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}  # noqa: E731
    cells, launches, lines = {}, {}, []
    for cell, fn, B in REMAT_CELLS:
        if fn == "mha_train_packed_seg":
            batch, Tp = to_dev(np_packed[0]), PACK_T
        else:
            batch = _train_batch(B, dcfg, 8)
            Tp = -(-(dcfg.topic_prompt_length + batch["targets"].shape[1]) // 128) * 128
        impl = "kernel_padded" if fn == "mha_train" else "auto"
        runs = {}
        for run in REMAT_RUNS:
            what = f"phase 21 {cell} {run}"
            tcfg = _remat_tcfg(run, impl)
            state, tx = ttrain.create_train_state(7, mcfg, tcfg, 1, 200, params,
                                                  device=DEVICE)
            step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx)
            state, r = _timed_steps(step, state, const, [batch], 1, REMAT_STEPS)
            _check_trained(what, r, state)
            _only(r["launches"], _train_launches(fn, L, REMAT_STEPS, batch, dcfg,
                                                 policy=tcfg.remat_policy,
                                                 remat=tcfg.remat), what)
            runs[run] = {k: r[k] for k in ("step_ms", "step_ms_all", "samples_per_s",
                                           "peak_memory_gib", "losses", "launches")}
            # no share for packed rows: the FLOP model has no packed form
            if fn != "mha_train_packed_seg":
                runs[run]["roofline"] = train_share(what, mcfg, dcfg, B, r["step_ms"],
                                                    tcfg.remat)
            del state, step, tx, r
            gc.collect()
            torch.cuda.empty_cache()
        full_peak = runs["full"]["peak_memory_gib"] * 2 ** 30
        for run in REMAT_POLICIES:
            runs[run]["predicted_extra_gb"] = remat_kept_bytes(
                run, B, Tp, g.n_embd, g.n_head, L, head_major=fn == "mha_train") / 1e9
            runs[run]["measured_extra_gb"] = (runs[run]["peak_memory_gib"] * 2 ** 30
                                              - full_peak) / 1e9
        cells[cell] = dict(fn=fn, rows=B, Tp=Tp, runs=runs)
        launches[cell] = {run: v["launches"] for run, v in runs.items()}
        lines.append(f"{cell} ({fn}, {B} rows of {Tp}): " + ", ".join(
            f"{run} {v['step_ms']:.1f} ms {v['samples_per_s']:.0f}/s "
            + (f"{_mfu(v['roofline'])} " if "roofline" in v else "")
            + f"{v['peak_memory_gib']:.2f} GiB"
            + (f" (+{v['measured_extra_gb']:.2f} GB, predicted "
               f"+{v['predicted_extra_gb']:.2f})" if run in REMAT_POLICIES[1:] else "")
            + f" fwd/bwd {v['launches'][fn + '_fwd']}/{v['launches'][fn + '_bwd']}"
            for run, v in runs.items()))
    peaks = [cells["B256"]["runs"][run]["peak_memory_gib"] for run in REMAT_RUNS]
    check(peaks[0] < peaks[1] < peaks[2] < peaks[3] <= peaks[4],
          f"phase 21 B256: peak memory not ordered full < save_qkv_ctx < "
          f"save_ctx_fc1 < save_all <= no_remat: {peaks}")
    _, small = packed_batches(dcfg, 24, 4, 12)
    f32 = {"B8": _remat_f32_compare(params, const, mcfg, dcfg, _train_batch(8, dcfg, 9),
                                    "phase 21 f32 B=8"),
           "packed_4_rows": _remat_f32_compare(params, const, mcfg, dcfg,
                                               to_dev(small[0]),
                                               "phase 21 f32 packed 4 rows")}
    out["remat"] = dict(cells=cells, f32=f32, steps=REMAT_STEPS)
    print(f"phase 21 remat policies (full width, bf16 compute / f32 masters, dropout "
          f"on, 1 + {REMAT_STEPS} steps a run, on {gpu}): ok; " + "; ".join(lines)
          + "; f32 with dropout, each policy vs no remat: " + ", ".join(
              f"{k} max {max(p['grad_rel_err'] for p in v['policies'].values()):.2g} "
              f"of the largest leaf" for k, v in f32.items()))
    del params, const
    torch.cuda.empty_cache()
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
    # 4 train steps x 2 layers x a forward ("auto" keeps the context of 8
    # rows) and a backward, plus the eval forwards
    check(counts["mha_train_packed_bwd"] == 4 * 2
          and counts["mha_train_packed_fwd"] > 4 * 2,
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
    # train steps go through the segment kernel (2 layers, a forward and a
    # backward: "auto" keeps the context of 8 rows of 512); eval stays
    # unpacked: forwards of mha_train_packed
    n = counts["mha_train_packed_seg_bwd"] // 2
    _only(counts, {"mha_train_packed_seg_fwd": 2 * n, "mha_train_packed_seg_bwd": 2 * n,
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
        _only(r["launches"], _train_launches("mha_train_packed", L,
                                             CHANNEL_TRAIN_STEPS, train_batch, dcfg),
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
    _only(r["launches"], _train_launches("mha_train_packed", L, ENGLISH_TRAIN_STEPS,
                                         batch, dcfg), "english train")
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
    # 32 steps x 2 layers, a forward ("auto" keeps the context of 2 rows) and
    # a backward each, plus the eval forwards
    check(counts["mha_train_packed_bwd"] == 2 * 32
          and counts["mha_train_packed_fwd"] > 2 * 32,
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


# ---------------------------------------------------------------------------
# Phase 22: the quality loop (mmtg_tpu_torch.quality_loop) at full width

# the reference's 5-epoch curriculum [1,3] (stage 1 at 2 x 32 rows), then
# each mode's generate CLI over 4 test records x 2 samples (a decode batch
# of 8) with each seed; the packing A/B over 3 epochs on the same widths
QUALITY = dict(n_train=512, n_val=64, epochs=5, batch_size=32, gen_seeds=(7, 8, 9))
PACK_AB = dict(n_train=512, n_val=64, epochs=3, batch_size=32)
# each mode's decode-attention kernel: a launch a layer and step
QUALITY_KERNEL = {"model": "decode_attention_fp_append",
                  "topk_approx": "decode_attention_fp_append",
                  "int8": "decode_attention_int8_append",
                  "int8_w8": "decode_attention_int8_append",
                  "int4": "decode_attention_int4_append"}


def _curriculum_launches(L, n_train, n_val, epochs, batch_size, dcfg,
                         val_batch_size=16, val_interval_ratio=0.5,
                         curriculums=(1, 3)):
    """mha_train_packed's launches in a train CLI run: each step's forward
    and backward (train._resolve_remat_policy at the epoch's batch), and a
    forward a layer for every val batch of every evaluation (each
    ``val_every`` steps and at each epoch's end; stage 1 doubles both
    batches)."""
    import math

    import torch

    from mmtg_tpu_torch.loss import stage_for_epoch

    fwd = bwd = 0
    for e in range(epochs):
        double = stage_for_epoch(e, curriculums) == 1
        bs = 2 * batch_size if double else batch_size
        vbs = 2 * val_batch_size if double else val_batch_size
        steps = math.ceil(n_train / bs)
        c = _train_launches("mha_train_packed", L, steps,
                            {"targets": torch.empty(bs, dcfg.target_length)}, dcfg)
        val_every = max(int(steps * val_interval_ratio), 1)
        evals = 1 + sum(1 for s in range(1, steps) if (s + 1) % val_every == 0)
        fwd += c["mha_train_packed_fwd"] + L * evals * math.ceil(n_val / vbs)
        bwd += c["mha_train_packed_bwd"]
    return {"mha_train_packed_fwd": fwd, "mha_train_packed_bwd": bwd}


def _mean_std(d):
    return f"{d['mean']:.4f} ± {d['std']:.4f}"


def phase_quality(out, gpu, tmp):
    """Phase 22: ``quality_loop.run`` and ``run_pack_ab`` at full width,
    bf16 compute / f32 masters, dropout on, through the train and generate
    CLIs on the card; the launch counts of every train run and every
    generate call, each set to 0 just before and read just after it."""
    import contextlib

    import torch

    from mmtg_tpu_torch import generate as gen_cli
    from mmtg_tpu_torch import quality_loop as ql
    from mmtg_tpu_torch.data import load_token_embedding_table

    mcfg, dcfg = model_configs()
    L = mcfg.gpt2.n_layer
    seen = {}

    @contextlib.contextmanager
    def observe(label):
        torch.cuda.synchronize()
        _reset_counts()  # ---- each run of this path starts here ------------------
        yield
        torch.cuda.synchronize()
        seen[label] = _counts()  # ---- read just after it ---------------------------

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "quality")
    rep = ql.run(**QUALITY, work_dir=work, device=DEVICE, dtype="bfloat16",
                 mcfg=mcfg, dcfg=dcfg, observe=observe)
    loop_s = time.perf_counter() - t_phase
    curve = rep["val_loss_curve"]
    check(len(curve) == QUALITY["epochs"] and all(abs(v) < 1e6 for v in curve),
          f"phase 22: val curve {curve}")
    check(rep["learned"] and curve[-1] < curve[0],
          f"phase 22: the val loss did not fall across the stages: {curve}")
    _only(seen["train"], _curriculum_launches(L, QUALITY["n_train"], QUALITY["n_val"],
                                              QUALITY["epochs"],
                                              QUALITY["batch_size"], dcfg),
          "phase 22 curriculum train CLI")
    for mode, kernel in QUALITY_KERNEL.items():
        m = rep["config"]["modes"][mode]
        for s in QUALITY["gen_seeds"]:
            lines = rep["samples"][mode][s]
            check(len(lines) == 8 and all(ln.strip() for ln in lines),
                  f"phase 22 {mode} seed {s}: {len(lines)} lines")
            _only(seen[f"generate {mode} s{s}"],
                  {kernel: L * LENGTH, "fused_gru": 2},
                  f"phase 22 generate {mode} ({m['cache_dtype']} cache, "
                  f"{m['weight_dtype']} weights) seed {s}")
    check(rep["config"]["modes"]["model"]["cache_dtype"] == "model"
          and rep["config"]["modes"]["model"]["weight_dtype"] == "model",
          f"phase 22: the fp baseline resolves to {rep['config']['modes']['model']}")
    check(rep["fp_repeat_identical"],
          "phase 22: the model mode wrote other lines with the same seed")
    # what each of the generate CLI's calls loads before it decodes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_token_embedding_table(os.path.join(work, "emb.pkl"), 13317,
                               dcfg.wenlan_emb_size)
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen_cli.load_params(os.path.join(work, "ckpt"), mcfg, DEVICE)
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pack = ql.run_pack_ab(**PACK_AB, work_dir=os.path.join(tmp, "quality_pack"),
                          device=DEVICE, dtype="bfloat16", mcfg=mcfg, dcfg=dcfg,
                          observe=observe)
    pack_s = time.perf_counter() - t0
    for tag in ("parity", "packed"):
        c = pack[tag]["val_curve"]
        check(len(c) == PACK_AB["epochs"] and all(abs(v) < 1e6 for v in c),
              f"phase 22 pack A/B {tag}: val curve {c}")
    parity_steps = sum(pack["parity"]["steps_per_epoch"])
    check(len(pack["parity"]["steps_per_epoch"]) == PACK_AB["epochs"],
          f"phase 22 pack A/B: steps {pack['parity']['steps_per_epoch']}")
    p, q = seen["train parity"], seen["train packed"]
    check(p["mha_train_packed_bwd"] == L * parity_steps
          and p["mha_train_packed_seg_bwd"] == 0,
          f"phase 22 pack A/B parity: launch counts {p}")
    check(q["mha_train_packed_seg_bwd"] > 0 and q["mha_train_packed_seg_bwd"] % L == 0
          and q["mha_train_packed_seg_fwd"] >= q["mha_train_packed_seg_bwd"]
          and q["mha_train_packed_bwd"] == 0,
          f"phase 22 pack A/B packed: launch counts {q}")
    wall = time.perf_counter() - t_phase
    totals = {}
    for counts in seen.values():
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    gen_s = [t for ts in rep["seconds"]["generate"].values() for t in ts]
    s0 = QUALITY["gen_seeds"][0]
    out["quality"] = dict(report={k: v for k, v in rep.items() if k != "samples"},
                          samples={m: rep["samples"][m][s0] for m in rep["samples"]},
                          pack_ab=pack, launches=seen, loop_s=loop_s,
                          pack_ab_s=pack_s, phase_s=wall, table_load_s=table_s,
                          params_load_s=params_s, gpu=gpu)
    vs_fp = rep["cache_mode_vs_fp"]
    print(f"phase 22 quality loop (full width, bf16 compute, dropout on, on {gpu}): "
          f"ok; {wall:.1f} s (loop {loop_s:.1f} s: train {rep['seconds']['train']:.1f} "
          f"s, {len(gen_s)} generate CLI calls {sum(gen_s):.1f} s, median "
          f"{statistics.median(gen_s):.2f} s, of which the table load {table_s:.2f} s "
          f"and the params load {params_s:.2f} s; pack A/B {pack_s:.1f} s)")
    print(f"phase 22 curriculum [1,3], {QUALITY['n_train']} samples, batch "
          f"{QUALITY['batch_size']} (stage 1 {2 * QUALITY['batch_size']}): val loss "
          + " -> ".join(f"{v:.4f}" for v in curve)
          + f", final {rep['final_val_loss']:.6f}; launches "
          f"{dict((k, v) for k, v in seen['train'].items() if v)}")
    print("phase 22 per mode (seeds " + ", ".join(map(str, QUALITY["gen_seeds"]))
          + "), bleu2 / distinct2 mean ± std vs the corpus: "
          + "; ".join(f"{m} {_mean_std(g['bleu2'])} / {_mean_std(g['distinct2'])}"
                      for m, g in rep["gen_vs_corpus"].items()))
    print(f"phase 22 vs the fp decode, seed {s0}"
          + ", bleu2: " + "; ".join(f"{m} {v['bleu']['bleu2']:.4f}"
                                    for m, v in vs_fp.items())
          + "; fp vs fp across seeds (the control): "
          + "; ".join(f"{k} {v:.4f}" for k, v in rep["fp_seed_divergence_control"].items())
          + f"; fp repeated with one seed: identical lines; first fp line: "
          f"{rep['samples']['model'][s0][0][:60]!r}")
    print(f"phase 22 pack A/B ({PACK_AB['epochs']} epochs, --pack_row_len 256): parity "
          + " -> ".join(f"{v:.4f}" for v in pack["parity"]["val_curve"])
          + " (" + f"{pack['parity']['seconds']:.1f} s), packed "
          + " -> ".join(f"{v:.4f}" for v in pack["packed"]["val_curve"])
          + f" ({pack['packed']['seconds']:.1f} s), both learned: {pack['both_learned']}; "
          f"packed launches {dict((k, v) for k, v in q.items() if v)}")
    return totals


# ---------------------------------------------------------------------------
# Phase 19: the sharded serving path over a (data, model) process mesh

MESH_B = 64
MESH_JOBS = (  # (ranks, meshes) of each torchrun job; every mesh of a job
    (2, ((2, 1), (1, 2))),  # uses all its ranks
    (4, ((2, 2),)),
)
MESH_RUN_TIMEOUT_S = 480  # one torchrun job, its ranks' start included
MESH_LOGIT_TOL = 1e-4  # f32 sharded step vs single-device step, max-abs
AR_REPS = 50
# the runs that only show a kernel on the mesh path decode two sentence frames
SHORT_LENGTH = 44
MESH_JOB_CMD = (os.path.abspath(__file__), "--mesh-job")  # + the spec's path


def _mesh_runs(dp, tp):
    """(what, dtype name, GenerateConfig changes, expected launches a rank)
    of one mesh: the meshed 'auto' (full-precision cache) in bf16 at full
    length; at SHORT_LENGTH an explicit int8 cache (DP-only and TP) and the
    whole-step kernel on the DP-only mesh, where it is in scope."""
    runs = [("bf16 auto", "bfloat16", {},
             {"decode_attention_fp_append": 12 * LENGTH, "fused_gru": 2})]
    if (dp, tp) != (2, 2):
        runs.append(("bf16 int8 cache", "bfloat16",
                     dict(cache_dtype="int8", length=SHORT_LENGTH),
                     {"decode_attention_int8_append": 12 * SHORT_LENGTH,
                      "fused_gru": 2}))
    if tp == 1:
        runs.append(("bf16 fused", "bfloat16",
                     dict(cache_dtype="int8", weight_dtype="model", attn_impl="fused",
                          length=SHORT_LENGTH),
                     {"decode_block_fused": SHORT_LENGTH, "fused_gru": 2}))
    return runs


def _serve_window(samples, seeds, bucket, dtype):
    """A window as GenerationService._pack makes it: the rows, then pad rows
    that repeat row 0 with seed 0, up to the bucket; on the card."""
    import numpy as np
    import torch

    from mmtg_tpu_torch import serve

    rows = list(samples) + [samples[0]] * (bucket - len(samples))
    batch = {}
    for k in serve.SAMPLE_KEYS:
        arr = np.stack([np.asarray(r[k]) for r in rows])
        batch[k] = (torch.from_numpy(arr.astype(np.float32)).to(DEVICE, dtype)
                    if k in ("topic_emb", "img_embs", "r_embs")
                    else torch.from_numpy(arr.astype(np.int32)).to(DEVICE))
    seeds = torch.tensor(list(seeds) + [0] * (bucket - len(seeds)), dtype=torch.int32,
                         device=DEVICE)
    return batch, seeds


def mesh_job(spec_path):
    """One rank of phase 19, started by torchrun: every run of _mesh_runs on
    each mesh of the job, f32 against the single-device engine, streamed
    against one-shot, the all-reduce's time, the decode kernels and the GRU
    at the shard shapes against their plain versions; with a serve spec,
    the windows the meshed service will decode. Writes rank<r>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mmtg_tpu_torch import decoding, serve
    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.kernels import _build
    from mmtg_tpu_torch.models import gpt2
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.parallel import mesh as pmesh

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = pmesh.init_distributed("cuda")
    t0 = time.perf_counter()
    _build.load()  # the library phase 1 built; a rank waits if one is building
    res = dict(rank=info.rank, world=info.world_size, backend=info.backend,
               device=str(info.device), load_s=time.perf_counter() - t0, meshes={})
    inputs = {}
    for dname in ("bfloat16", "float32"):
        mcfg, dcfg, params, const, make_batch = _full_width_inputs(
            getattr(torch, dname), 0)
        inputs[dname] = (params, const, make_batch(MESH_B))
    key = prng.PRNGKey(3, device=DEVICE)
    seeds = torch.arange(MESH_B, dtype=torch.int32, device=DEVICE) * 7 + 1
    ref = None
    if info.rank == 0:  # the single-device f32 engine on the global batch
        params, const, batch = inputs["float32"]
        # the cache the meshed 'auto' resolves to
        ref = decoding.generate(params, const, mcfg, dcfg,
                                GenerateConfig(cache_dtype="model", weight_dtype="auto"),
                                batch, key, row_seeds=seeds)
    with torch.no_grad():
        for j, (dp, tp) in enumerate(spec["meshes"]):
            mesh = pmesh.make_mesh((dp, tp), info.device)
            data_group, model_group = pmesh.groups(mesh)
            rows = pmesh.local_rows(MESH_B, mesh)
            m = dict(coords=list(pmesh.mesh_coords(mesh)), runs={})
            if j == 0:  # warm-up (cuBLAS handles, the allocator), untimed
                for dname in ("bfloat16", "float32"):
                    params, const, batch = inputs[dname]
                    decoding.generate_sharded(
                        params, const, mcfg, dcfg, GenerateConfig(length=22), batch,
                        key, mesh, row_seeds=seeds)
            for what, dname, change, expected in _mesh_runs(dp, tp):
                params, const, batch = inputs[dname]
                gcfg = GenerateConfig(**{"cache_dtype": "auto", "weight_dtype": "auto",
                                         **change})
                torch.cuda.synchronize()
                dist.barrier()
                _reset_counts()  # ---- the main path starts here ----------------
                sums = gpt2.tp_sum.calls
                t0 = time.perf_counter()
                toks = decoding.generate_sharded(params, const, mcfg, dcfg, gcfg, batch,
                                                 key, mesh, row_seeds=seeds)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _counts()  # ---- read just after the main path ------
                _only(launches, expected, f"phase 19 {dp}x{tp} {what}")
                _check_tokens(toks, mcfg, dcfg, f"phase 19 {dp}x{tp} {what}",
                              gcfg.length)
                m["runs"][what] = dict(wall_s=wall, launches=launches,
                                       length=gcfg.length,
                                       all_reduces_per_step=(gpt2.tp_sum.calls - sums)
                                       / gcfg.length)
            # f32: the sharded engine, streamed vs one-shot, vs one device
            params, const, batch = inputs["float32"]
            gcfg = GenerateConfig(cache_dtype="auto", weight_dtype="auto")
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            toks = decoding.generate_sharded(params, const, mcfg, dcfg, gcfg, batch, key,
                                             mesh, row_seeds=seeds)
            torch.cuda.synchronize()
            m["runs"]["f32 auto"] = dict(wall_s=time.perf_counter() - t0)
            blocks = list(decoding.generate_stream_sharded(
                params, const, mcfg, dcfg, gcfg, batch, key, mesh, row_seeds=seeds))
            check(torch.equal(torch.cat(blocks, 1), toks[:, 1:]),
                  f"phase 19 {dp}x{tp}: generate_stream_sharded differs from "
                  "generate_sharded")
            m["stream_blocks"] = len(blocks)
            if ref is not None:
                m["f32_rows_equal_single_device"] = float(
                    (toks == ref).all(dim=1).float().mean())
            # the step's f32 logits on the same forced tokens: sharded vs one device
            local = {k: v[rows] for k, v in batch.items()}
            forced = toks[rows, :TF_STEPS]
            g = mcfg.gpt2
            fp = GenerateConfig(cache_dtype="model", weight_dtype="model")
            sharded = decoding.teacher_forced_decode_logits(
                pmesh.shard_decode_params(params, mesh, g.n_head, g.head_dim), const,
                mcfg, dcfg, fp, local, forced,
                tp_group=model_group if tp > 1 else None)
            single = decoding.teacher_forced_decode_logits(params, const, mcfg, dcfg,
                                                           fp, local, forced)
            err = (sharded - single).abs().max().item()
            check(err <= MESH_LOGIT_TOL, f"phase 19 {dp}x{tp}: f32 sharded step logits "
                  f"{err:.3g} from the single-device step's > {MESH_LOGIT_TOL}")
            m["f32_logits_max_abs"] = err
            if tp > 1:  # one all-reduce of the step's [B/dp, 768] partial sum
                for dname in ("bfloat16", "float32"):
                    x = torch.randn(MESH_B // dp, 768, device=DEVICE).to(getattr(torch, dname))
                    for _ in range(5):
                        dist.all_reduce(x, group=model_group)
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    start.record()
                    for _ in range(AR_REPS):
                        dist.all_reduce(x, group=model_group)
                    end.record()
                    end.synchronize()
                    m[f"all_reduce_ms_{dname}"] = dict(
                        device=start.elapsed_time(end) / AR_REPS,
                        host=(time.perf_counter() - t0) * 1e3 / AR_REPS)
            # the kernels at this rank's shard shapes vs their plain versions
            gen = torch.Generator(device=DEVICE).manual_seed(19)
            results, lines = {}, []
            for name, kind in (("decode_attention_fp_append", "fp"),
                               ("decode_attention_int8_append", "int8")):
                for dtype in (torch.bfloat16, torch.float32):
                    lines.append(_decode_vs_plain(results, da, name, kind, True, dtype,
                                                  MESH_B // dp, gen, H=12 // tp,
                                                  D=768 // tp, tag=f"H{12 // tp}"))
            for dtype in (torch.bfloat16, torch.float32):
                lines.append(_gru_vs_plain(results, fg, dtype, MESH_B // dp, gen))
            m["kernels"] = {"|".join(k): v for k, v in results.items()}
            m["kernel_lines"] = lines
            res["meshes"][f"{dp}x{tp}"] = m
            dist.barrier()
        serve_spec = spec.get("serve")
        if serve_spec:  # the windows the meshed service will decode, same mesh
            s = serve._serving_setup(serve.build_arg_parser().parse_args(
                serve_spec["argv"]), mcfg, dcfg)
            gcfg = serve._service_gcfg(s["gcfg"], s["buckets"], meshed=True)
            samples = [dict(np.load(p)) for p in serve_spec["samples"]]
            res["serve_windows"] = {}
            for name, idx, wseeds in serve_spec["windows"]:
                batch, wseeds = _serve_window([samples[i] for i in idx], wseeds,
                                              serve_spec["bucket"],
                                              s["const"]["wenlan_table"].dtype)
                toks = decoding.generate_sharded(
                    s["params"], s["const"], mcfg, dcfg, gcfg, batch,
                    prng.PRNGKey(serve_spec["seed"], device=DEVICE), s["mesh"],
                    row_seeds=wseeds)
                res["serve_windows"][name] = toks[:len(idx)].cpu().tolist()
    with open(os.path.join(spec["out"], f"rank{info.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _stop_torchrun(proc, grace_s=60.0):
    """End a ``torchrun`` and its ranks. SIGTERM first: the launcher starts
    each rank in a session of its own and stops them itself on SIGTERM,
    while a SIGKILL to it would leave them running."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(grace_s)


def _torchrun(nproc, args, timeout, cwd):
    """``python -m torch.distributed.run --standalone`` of ``args`` (a
    script or ``-m module`` and its flags) with ``nproc`` ranks; raises with
    the end of the output when a rank fails or the time runs out (the
    launcher and its ranks then stopped)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *args]
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop_torchrun(proc)
        raise
    check(proc.returncode == 0, f"torchrun {' '.join(args[:2])} ... exited "
          f"{proc.returncode}:\n{stdout[-4000:]}\n{stderr[-8000:]}")


SERVE_SEED, SERVE_BUCKETS = 5, "4,8"
# the service's first window: (sample, seed) of three one-shot requests and,
# last, a streamed one
SERVE_WINDOW = ([0, 1, 2, 4], [40, 41, 42, 77])
SERVE_CMD = ("-m", "mmtg_tpu_torch.serve")


def _mesh_serve(out, paths, tmp, samples, want, model):
    """``python -m mmtg_tpu_torch.serve`` on a (2, 2) mesh under torchrun,
    default device (the card): four requests over HTTP on a local port that
    share one window — three one-shot, one streamed — then a /reload and one
    more request, each held against generate_sharded on the same mesh with
    the same seeds (``want``: the window as the service packs it); then
    SIGTERM to rank 0, which stops its followers, and every rank exits 0."""
    import json as _json
    import queue
    import re
    import signal
    import threading
    import urllib.request

    import numpy as np

    from mmtg_tpu_torch import serve

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", *SERVE_CMD,
           *_serve_argv(paths, model), "--mesh_data", "2", "--mesh_model", "2",
           "--port", "0", "--no_warmup"]
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    log = []
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()

    def post(path, body, ctype=serve.NPZ_CONTENT_TYPE):
        req = urllib.request.Request(f"http://localhost:{port}{path}", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        port = pid = None
        deadline = time.monotonic() + MESH_RUN_TIMEOUT_S
        while port is None:
            line = lines.get(timeout=max(1.0, deadline - time.monotonic()))
            log.append(line)
            found = re.search(r"Serving on http://\S+:(\d+) .*pid (\d+)", line)
            if found:
                port, pid = int(found.group(1)), int(found.group(2))
        up_s = time.perf_counter() - t_start
        got, took = [None] * 4, [None] * 4

        def request(i):
            t = time.perf_counter()
            path = "/generate" if i < 3 else "/generate_stream"
            got[i] = post(path, serve.encode_request_npz(
                samples[SERVE_WINDOW[0][i]], seed=SERVE_WINDOW[1][i]))
            took[i] = time.perf_counter() - t

        threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
        for t in threads:  # in the window's row order, inside max_wait_ms
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(300)
        window_s = max(took)
        raw = got[3]
        got = [_json.loads(g) for g in got[:3]]
        events = [_json.loads(ev[len("data: "):]) for ev in raw.decode().split("\n\n")
                  if ev.startswith("data: ")]
        check(events[-1].get("done") is True and events[-1]["tokens_total"] == LENGTH,
              f"phase 19 serve stream: last event {events[-1]}")
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        check(_json.loads(post("/reload", _json.dumps({"model_path": model}).encode(),
                               "application/json"))["ok"] is True, "phase 19 /reload")
        again = _json.loads(post("/generate", serve.encode_request_npz(samples[0], seed=40)))
        for i in range(3):
            check(got[i]["tokens"] == want[i], f"phase 19 serve: response {i} differs "
                  "from generate_sharded with the same seeds on the same mesh")
        check(streamed == want[3][1:], "phase 19 serve: the streamed response differs "
              "from generate_sharded with the same seed")
        check(again["tokens"] == want[0], "phase 19 serve: after /reload the response "
              "differs from generate_sharded")
        os.kill(pid, signal.SIGTERM)  # rank 0 drains and stops its followers
        rc = proc.wait(timeout=120)
        check(rc == 0, f"phase 19 serve: torchrun exited {rc}")
    finally:
        _stop_torchrun(proc)
        reader.join(60)
        while not lines.empty():
            log.append(lines.get())
        with open(os.path.join(tmp, "mesh_serve.log"), "w") as f:
            f.writelines(log)
    stopped = [ln for ln in log if re.search(r"Follower rank \d stopped after \d+ windows", ln)]
    check(len(stopped) == 3, "phase 19 serve: not every follower stopped:\n"
          + "".join(log[-40:]))
    backend = next((re.search(r"backend (\w+)", ln).group(1) for ln in log
                    if "backend" in ln), "?")
    return dict(up_s=up_s, window_of_4_s=window_s, stream_s=took[3], backend=backend,
                followers=[ln[ln.index("Follower"):].strip() for ln in stopped])


def _serve_argv(paths, model):
    return ["--model_path", model, "--tokenizer_path", paths["vocab"],
            "--token_emb_path", paths["emb"], "--buckets", SERVE_BUCKETS,
            "--max_wait_ms", "500", "--seed", str(SERVE_SEED)]


def phase_mesh(out, gpu, paths, tmp):
    """Phase 19: the sharded serving path (see the module docstring)."""
    import numpy as np

    from mmtg_tpu_torch import serve
    from mmtg_tpu_torch.data import MMTGDataset, make_synthetic_records
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    import torch

    here = os.path.abspath(__file__)
    mcfg, dcfg = model_configs()
    t_phase = time.perf_counter()
    model = _reference_checkpoint(tmp)
    records = make_synthetic_records(5, np.random.default_rng(3),
                                     emb_size=dcfg.wenlan_emb_size)
    for r in records:
        r.pop("rating")
    ds = MMTGDataset.from_records(records, WordPieceTokenizer.from_file(paths["vocab"]),
                                  dcfg, if_train=False)
    samples = [{k: np.asarray(ds[i][k]) for k in serve.SAMPLE_KEYS} for i in range(5)]
    sample_files = []
    for i, smp in enumerate(samples):
        sample_files.append(os.path.join(tmp, f"mesh_sample{i}.npz"))
        np.savez(sample_files[-1], **smp)
    ranks, meshes, lines = {}, {}, []
    for nproc, job_meshes in MESH_JOBS:
        job_dir = os.path.join(tmp, f"mesh_job{nproc}")
        os.makedirs(job_dir, exist_ok=True)
        spec = dict(meshes=[list(m) for m in job_meshes], out=job_dir)
        if (2, 2) in job_meshes:  # the service's window of bucket 4
            spec["serve"] = dict(
                argv=_serve_argv(paths, model) + ["--mesh_data", "2", "--mesh_model", "2"],
                samples=sample_files, bucket=4, seed=SERVE_SEED,
                windows=[("window", *SERVE_WINDOW)])
        spec_path = os.path.join(job_dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        _torchrun(nproc, [*MESH_JOB_CMD, spec_path], MESH_RUN_TIMEOUT_S,
                  os.path.dirname(here))
        job_s = time.perf_counter() - t0
        got = []
        for r in range(nproc):
            with open(os.path.join(job_dir, f"rank{r}.json")) as f:
                got.append(json.load(f))
        ranks[nproc] = got
        for dp, tp in job_meshes:
            name = f"{dp}x{tp}"
            per_rank = [g["meshes"][name] for g in got]
            m = dict(per_rank[0], job_s=job_s, backend=got[0]["backend"],
                     load_s=[g["load_s"] for g in got])
            for what in m["runs"]:
                if "launches" in m["runs"][what]:
                    for pr in per_rank[1:]:
                        check(pr["runs"][what]["launches"] == m["runs"][what]["launches"],
                              f"phase 19 {name} {what}: ranks launched differently")
                m["runs"][what]["wall_s_ranks"] = [pr["runs"][what]["wall_s"]
                                                   for pr in per_rank]
            m["f32_logits_max_abs_ranks"] = [pr["f32_logits_max_abs"] for pr in per_rank]
            m["kernel_lines_ranks"] = [pr["kernel_lines"] for pr in per_rank]
            meshes[name] = m
            ar = m.get("all_reduce_ms_bfloat16")
            steps = m["runs"]["bf16 auto"]
            lines.append(
                f"{name} ({m['backend']}): generate_sharded B={MESH_B} {LENGTH} tokens "
                f"bf16 {steps['wall_s']:.2f} s, f32 {m['runs']['f32 auto']['wall_s']:.2f} s; "
                f"{steps['all_reduces_per_step']:g} all-reduces a step"
                + (f" at {ar['device']:.3f} ms each on the device ({ar['host']:.3f} ms host) "
                   f"= {ar['device'] * steps['all_reduces_per_step']:.1f} ms a step"
                   if ar else "")
                + "; launches a rank " + ", ".join(
                    f"{what}: {dict((k, v) for k, v in r['launches'].items() if v)}"
                    for what, r in m["runs"].items() if "launches" in r)
                + f"; TP ranks agree; f32 step logits max-abs "
                f"{max(m['f32_logits_max_abs_ranks']):.3g} (<= {MESH_LOGIT_TOL}); f32 rows "
                f"equal to single-device generate {m.get('f32_rows_equal_single_device', 0):.3f}; "
                f"streamed = one-shot ({m['stream_blocks']} blocks); kernels at the shard "
                f"shapes = plain: " + " | ".join(m["kernel_lines"]))
    want = ranks[4][0]["serve_windows"]["window"]
    srv = _mesh_serve(out, paths, tmp, samples, want, model)
    os.remove(model)
    wall = time.perf_counter() - t_phase
    out["mesh"] = dict(meshes=meshes, serve=srv, phase_s=wall)
    torch.cuda.synchronize()
    print(f"phase 19 sharded serving over torch.distributed ({torch.cuda.device_count()} "
          f"card(s), on {gpu}, {wall:.1f} s): ok; " + "; ".join(lines)
          + f"; serve (2,2) under torchrun ({srv['backend']}, f32, buckets {SERVE_BUCKETS}): "
          f"up in {srv['up_s']:.1f} s, 3 one-shot and 1 streamed request in one window "
          f"{srv['window_of_4_s']:.2f} s (the stream {srv['stream_s']:.2f} s), /reload, "
          f"every response = generate_sharded on the mesh; every rank stopped cleanly "
          f"({'; '.join(srv['followers'])})")
    return {name: m["runs"] for name, m in meshes.items()}


# ---------------------------------------------------------------------------
# Phase 20: training over the mesh (data, tensor, ZeRO-1, pipeline)

MESH_TRAIN_B, MESH_TRAIN_F32_B = 32, 8  # global batches: bf16 timed, f32 compared
MESH_PIPE_MICRO = 4
MESH_PACK_ROWS, MESH_PACK_F32_ROWS = 16, 4  # packed rows of PACK_T, global
# name -> (second mesh axis, shape, zero1, attn_impl, packed rows, timed steps)
MESH_TRAIN_RUNS = {
    "dp": ("model", (2, 1), False, "auto", False, 3),
    "tp": ("model", (1, 2), False, "auto", False, 3),
    "zero1": ("model", (2, 1), True, "auto", False, 3),
    "pipe": ("pipe", (1, 2), False, "auto", False, 3),
    "packed": ("model", (2, 1), False, "auto", True, 3),
    "tp_head_major": ("model", (1, 2), False, "kernel_padded", False, 1),
    "dp_tp": ("model", (2, 2), False, "auto", False, 3),
}
MESH_TRAIN_JOBS = ((2, ("dp", "tp", "zero1", "pipe", "packed", "tp_head_major")),
                   (4, ("dp_tp",)))
MESH_TRAIN_TIMEOUT_S = 420  # one torchrun job, its ranks' start included
MESH_TRAIN_CMD = (os.path.abspath(__file__), "--mesh-train-job")  # + the spec's path
# #9 on a data rank's 8 packed rows: a short segment's ctx is close to its own
# v row, so |ctx| reaches 4-6 where one bf16 step is 0.03125 (the bf16
# forward rounds the un-normalised probabilities: within one step)
SHARD_SEG_TOL = {"float32": SEG_TOL["float32"], "bfloat16": (3.2e-2, 8e-2, 2e-2)}


def _mesh_train_fn(name):
    """The train-attention function a run's layers call."""
    _, _, _, impl, packed, _ = MESH_TRAIN_RUNS[name]
    return ("mha_train_packed_seg" if packed else
            "mha_train" if impl == "kernel_padded" else "mha_train_packed")


def _mesh_train_launches(name, steps, policy, n_layer=L):
    """Launches a rank in ``steps`` steps under the resolved remat ``policy``:
    a forward and a backward a layer, and the remat forward again under
    "full"; a stage runs its layers on each micro-batch, and the backward
    recomputes the stage's forward under any policy."""
    axis, shape, *_ = MESH_TRAIN_RUNS[name]
    fn = _mesh_train_fn(name)
    per = n_layer // shape[1] * MESH_PIPE_MICRO if axis == "pipe" else n_layer
    again = axis == "pipe" or policy == "full"
    return {f"{fn}_fwd": (2 if again else 1) * per * steps, f"{fn}_bwd": per * steps}


def _mesh_for(name, device):
    from mmtg_tpu_torch.parallel import mesh as pmesh
    from mmtg_tpu_torch.parallel.pipeline import make_dp_pp_mesh

    axis, shape, *_ = MESH_TRAIN_RUNS[name]
    if axis == "pipe":
        mesh = make_dp_pp_mesh(*shape, device)
        return mesh, (mesh, MESH_PIPE_MICRO)
    return pmesh.make_mesh(shape, device), None


def _replicated_bit_equal(params, layout):
    """Every leaf the ranks hold whole, bit-equal on every rank."""
    import torch
    import torch.distributed as dist

    from mmtg_tpu_torch.params import tree_leaves

    ok = True
    for leaf, sharded in zip(tree_leaves(params), layout.sharded_mask(params)):
        if not sharded:
            parts = [torch.empty_like(leaf) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, leaf.detach().contiguous())
            ok &= all(torch.equal(p, parts[0]) for p in parts)
    return ok


def _mesh_bf16_steps(name, mesh, pp, mcfg, dcfg, params, const, batch):
    """1 warm-up + the run's timed bf16 steps (dropout, remat) on this rank's
    rows, then one step with every collective timed (and, on a TP mesh, one
    step under "full" whose collectives are counted beside these)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import TrainConfig
    from mmtg_tpu_torch.parallel import mesh as pmesh
    from mmtg_tpu_torch.params import tree_leaves

    _, _, zero1, impl, _, steps = MESH_TRAIN_RUNS[name]
    tcfg = TrainConfig(dtype="bfloat16", remat=True, lr=1e-4, alpha=0.2, attn_impl=impl)
    full, tx = ttrain.create_train_state(7, mcfg, tcfg, 1, 200, params, device=DEVICE)
    state = ttrain.shard_train_state(full, mcfg, mesh, zero1=zero1)
    del full
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx, pp=pp, zero1=zero1, mesh=mesh)
    local = {k: v[pmesh.local_rows(v.shape[0], mesh)] for k, v in batch.items()}
    state, _ = step(state, const, local, 3)  # also the schedule's rate-0 update
    torch.cuda.synchronize()
    dist.barrier()
    pmesh.comm.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # ---- the main path starts here ------------------------------
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, const, local, 3)
        losses.append(float(m["loss"]))  # waits for the card
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = _counts()  # ---- read just after the main path --------------------
    calls = {k: v / steps for k, v in pmesh.comm.calls.items()}
    mbytes = {k: v / steps / 1e6 for k, v in pmesh.comm.bytes.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    what = f"phase 20 {name}"
    layout = pmesh.train_layout(mesh)
    policy = ttrain._resolve_remat_policy(tcfg.remat_policy, local, pp,
                                          dcfg.topic_prompt_length, layout.dp)
    _only(launches, _mesh_train_launches(name, steps, policy), what)
    check(all(x == x and abs(x) < 1e6 for x in losses), f"{what}: loss {losses}")
    check(steps == 1 or losses[-1] < losses[0], f"{what}: loss did not fall {losses}")
    # one more step, each collective between two synchronizations
    pmesh.comm.reset()
    pmesh.comm.timed = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, const, local, 3)
    torch.cuda.synchronize()
    timed_wall = time.perf_counter() - t0
    pmesh.comm.timed = False
    coll_ms = {k: v * 1e3 for k, v in pmesh.comm.seconds.items()}
    calls_full = None
    if layout.tp > 1 and policy != "full":
        # the same step recomputing whole blocks: its collectives beside these
        step_full = ttrain.make_train_step(
            mcfg, dcfg, dataclasses.replace(tcfg, remat_policy="full"), tx, pp=pp,
            zero1=zero1, mesh=mesh)
        pmesh.comm.reset()
        state, _ = step_full(state, const, local, 3)
        torch.cuda.synchronize()
        calls_full = dict(pmesh.comm.calls)
        del step_full
    same = _replicated_bit_equal(state.params, layout)
    check(same, f"{what}: a replicated leaf differs between ranks")
    moments = state.opt_state["mu"], state.opt_state["nu"]
    r = dict(step_ms=statistics.median(times) * 1e3, step_ms_all=[t * 1e3 for t in times],
             losses=losses, launches=launches, collectives_per_step=calls,
             collective_mb_per_step=mbytes, timed_step_ms=timed_wall * 1e3,
             remat_policy=policy, collectives_per_step_full=calls_full,
             collective_ms_timed_step=coll_ms,
             collective_share=sum(coll_ms.values()) / (timed_wall * 1e3),
             peak_memory_gib=peak, replicated_bit_equal=same,
             moment_bytes=sum(t.numel() * t.element_size()
                              for m in moments for t in tree_leaves(m)),
             rows=next(iter(local.values())).shape[0])
    del state, step
    torch.cuda.empty_cache()
    return r


def _single_device_f32(mcfg, dcfg, params, const, batch):
    """The single-device f32 reference on the card: loss, every gradient leaf,
    and the parameters and moments after two steps."""
    import torch

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import TrainConfig
    from mmtg_tpu_torch.params import tree_leaves

    tcfg = TrainConfig(dtype="float32", remat=False, lr=1e-4, alpha=0.2)
    state, tx = ttrain.create_train_state(7, mcfg, tcfg, 1, 200, params, device=DEVICE)
    total, _ = ttrain.loss_and_metrics(state.params, const, mcfg, dcfg, tcfg, batch, 3,
                                       None, True)
    grads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx)
    for _ in range(2):
        state, _ = step(state, const, batch, 3)
    return dict(total=float(total.detach()),
                grads=[torch.zeros_like(p) if g is None else g
                       for p, g in zip(tree_leaves(state.params), grads)],
                params=[p.detach() for p in tree_leaves(state.params)],
                mu=tree_leaves(state.opt_state["mu"]), nu=tree_leaves(state.opt_state["nu"]))


def _mesh_f32_compare(name, mesh, pp, mcfg, dcfg, params, const, batch, ref):
    """The f32 mesh step (dropout off) against the single-device one: loss and
    every gradient leaf gathered to full, then the parameters and moments
    after two steps (held on rank 0, where ``ref`` is)."""
    import torch

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import TrainConfig
    from mmtg_tpu_torch.parallel import mesh as pmesh
    from mmtg_tpu_torch.params import tree_leaves

    _, _, zero1, impl, _, _ = MESH_TRAIN_RUNS[name]
    tcfg = TrainConfig(dtype="float32", remat=True, lr=1e-4, alpha=0.2, attn_impl=impl)
    full, tx = ttrain.create_train_state(7, mcfg, tcfg, 1, 200, params, device=DEVICE)
    state = ttrain.shard_train_state(full, mcfg, mesh, zero1=zero1)
    del full
    layout = pmesh.train_layout(mesh)
    local = {k: v[pmesh.local_rows(v.shape[0], mesh)] for k, v in batch.items()}
    grads, num = ttrain._numerators(
        state.params, const, mcfg, dcfg, tcfg, local, 3, None,
        tp_group=layout.split_group if layout.tp > 1 else None, pp=pp)
    grads, num, _ = ttrain._MeshSums(layout, state.params).reduce(grads, num)
    total = float(ttrain._metrics(num)["total"])
    grads = tree_leaves(ttrain._full_tree(ttrain._unflatten(state.params, grads), mcfg,
                                          layout))
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx, pp=pp, zero1=zero1, mesh=mesh)
    for _ in range(2):
        state, _ = step(state, const, local, 3)
    same = _replicated_bit_equal(state.params, layout)
    gathered = ttrain.gather_train_state(state, mcfg, mesh, zero1=zero1)
    r = dict(replicated_bit_equal=same)
    what = f"phase 20 {name} f32"
    check(same, f"{what}: a replicated leaf differs between ranks")
    if ref is not None:
        def err(a, b):
            return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))

        r.update(loss_abs_err=abs(total - ref["total"]), grad_max_abs_err=err(
            grads, ref["grads"]), params_max_abs_err=err(
            tree_leaves(gathered.params), ref["params"]), mu_max_abs_err=err(
            tree_leaves(gathered.opt_state["mu"]), ref["mu"]), nu_max_abs_err=err(
            tree_leaves(gathered.opt_state["nu"]), ref["nu"]))
        for k in ("loss_abs_err", "grad_max_abs_err", "params_max_abs_err",
                  "mu_max_abs_err", "nu_max_abs_err"):
            check(r[k] <= MESH_LOGIT_TOL, f"{what}: {k} {r[k]:.3g} > {MESH_LOGIT_TOL} "
                  "against the single-device step")
    del state, step, gathered, grads
    torch.cuda.empty_cache()
    return r


def _shard_kernels(name, results, gen, batch):
    """The run's attention function at this rank's shapes against its plain
    version, timed beside SDPA: #8 on a TP rank's 6 heads, #9 on a data
    rank's packed rows (their real segment ids)."""
    import torch

    from mmtg_tpu_torch.ops import train_attention as ta
    from mmtg_tpu_torch.parallel import mesh as pmesh  # noqa: F401

    hd, lines = TRAIN_HD, []
    packed = MESH_TRAIN_RUNS[name][4]
    heads = H // MESH_TRAIN_RUNS[name][1][1] if not packed else H
    if packed:
        seg = batch["seg"]
        B, T = seg.shape
        tril = torch.ones(T, T, dtype=torch.bool, device=DEVICE).tril()
        allowed = (seg[:, :, None] == seg[:, None, :]) & tril
        mask, pairs = seg.contiguous(), float(heads * int(allowed.sum()))
        sdpa_mask = allowed[:, None]
        fn, plain, tols = (ta.mha_train_packed_seg, ta.mha_train_packed_seg_plain,
                           SHARD_SEG_TOL)
    else:
        B, T = MESH_TRAIN_B // MESH_TRAIN_RUNS[name][1][0], TRAIN_T
        mask = _key_bias(B, T)
        pairs, sdpa_mask = B * heads * T * (T + 1) / 2, _sdpa_mask(mask, T)
        fn, plain, tols = ta.mha_train_packed, ta.mha_train_packed_plain, TRAIN_TOL
    S3 = 3 * heads * hd
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(B, T, S3, generator=gen, device=DEVICE).to(dtype)
        qb = (torch.randn(S3, generator=gen, device=DEVICE) * 0.1).to(dtype)
        co = torch.randn(B, T, heads * hd, generator=gen, device=DEVICE).to(dtype)

        def sdpa_inputs():
            q, k, v = (qkv + qb).view(B, T, 3, heads, hd).permute(2, 0, 3, 1, 4)
            return q, k, v, sdpa_mask

        lines += _attention_vs_plain(
            results, fn.__name__, fn, plain, dtype, B, qkv, qb, mask, co, hd ** -0.5,
            sdpa_inputs, _io_bytes(B, T, S3, heads * hd, qkv.element_size()), pairs,
            hd, tols=tols, heads=heads, key=f"{name}:H{heads}xB{B}xT{T}")
        del qkv, qb, co
        torch.cuda.empty_cache()
    return lines


def mesh_train_job(spec_path):
    """One rank of phase 20, started by torchrun: each run of the spec on its
    mesh — bf16 steps timed, the f32 step against the single-device step, the
    attention function at this rank's shapes. Writes rank<r>.json."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from mmtg_tpu_torch.kernels import _build
    from mmtg_tpu_torch.parallel import mesh as pmesh

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = pmesh.init_distributed(DEVICE)
    t0 = time.perf_counter()
    _build.load()  # the library phase 1 built; a rank waits if one is building
    res = dict(rank=info.rank, world=info.world_size, backend=info.backend,
               device=str(info.device), load_s=time.perf_counter() - t0, runs={})
    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7)
    g = mcfg.gpt2
    mcfg32 = dataclasses.replace(mcfg, dropout=0.0, gpt2=dataclasses.replace(
        g, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))
    to_dev = lambda b: {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}  # noqa: E731
    batches = {False: (_train_batch(MESH_TRAIN_B, dcfg, 8),
                       _train_batch(MESH_TRAIN_F32_B, dcfg, 9))}
    if any(MESH_TRAIN_RUNS[n][4] for n in spec["runs"]):
        _, pbs = packed_batches(dcfg, 5 * MESH_PACK_ROWS, MESH_PACK_ROWS, 5)
        packed = to_dev(pbs[0])
        batches[True] = (packed, {k: v[:MESH_PACK_F32_ROWS] for k, v in packed.items()})
    refs = {}
    if info.rank == 0:  # the single-device f32 references, once a batch kind
        for kind, (_, b32) in batches.items():
            refs[kind] = _single_device_f32(mcfg32, dcfg, params, const, b32)
    gen = torch.Generator(device=DEVICE).manual_seed(20 + info.rank)
    for name in spec["runs"]:
        packed = MESH_TRAIN_RUNS[name][4]
        mesh, pp = _mesh_for(name, info.device)
        r = _mesh_bf16_steps(name, mesh, pp, mcfg, dcfg, params, const,
                             batches[packed][0])
        if name != "tp_head_major":
            r["f32"] = _mesh_f32_compare(name, mesh, pp, mcfg32, dcfg, params, const,
                                         batches[packed][1], refs.get(packed))
        if name in ("tp", "packed"):
            results = {}
            local = {k: v[pmesh.local_rows(v.shape[0], mesh)]
                     for k, v in batches[packed][0].items()}
            r["kernel_lines"] = _shard_kernels(name, results, gen, local)
            r["kernels"] = {"|".join(str(x) for x in k): v for k, v in results.items()}
        res["runs"][name] = r
        dist.barrier()
    with open(os.path.join(spec["out"], f"rank{info.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


MESH_CLI_CMD = ("-m", "mmtg_tpu_torch.train")


def _mesh_train_cli(paths, tmp):
    """The train CLI under torchrun at depth 2 (default device: the card):
    an epoch on --mesh_data 2 --zero1, --resume of its save path on
    --mesh_model 2, then the single-device generate CLI on that save path."""
    import dataclasses

    import torch

    from mmtg_tpu_torch import generate as gen_cli

    mcfg, dcfg = model_configs()
    mcfg = dataclasses.replace(mcfg, gpt2=dataclasses.replace(mcfg.gpt2, n_layer=2))
    cfg_json = os.path.join(tmp, "gpt2_depth2.json")
    with open(cfg_json, "w") as f:
        json.dump(dataclasses.asdict(mcfg.gpt2), f)
    save = os.path.join(tmp, "mesh_ckpt")
    args = ["--train_data_path", paths["train"], "--val_data_path", paths["val"],
            "--vocab_path", paths["vocab"], "--token_emb_path", paths["emb"],
            "--model_config_json", cfg_json, "--batch_size", "8", "--val_batch_size",
            "8", "--curriculums", "0,0", "--alpha", "0.2", "--lr", "1e-4",
            "--val_interval_ratio", "1.0", "--log_interval", "1", "--save_model",
            "--save_path", save]
    here = os.path.dirname(os.path.abspath(__file__))
    state_dir = os.path.join(save, "train_state")
    t0 = time.perf_counter()
    _torchrun(2, [*MESH_CLI_CMD, *args, "--epochs", "1", "--mesh_data", "2", "--zero1"],
              MESH_TRAIN_TIMEOUT_S, here)
    zero1_s = time.perf_counter() - t0
    first = sorted(os.listdir(state_dir))
    check(first == ["step_00000002.pt"], f"phase 20 CLI --zero1 checkpoints: {first}")
    t0 = time.perf_counter()
    _torchrun(2, [*MESH_CLI_CMD, *args, "--epochs", "2", "--resume", "--mesh_model", "2"],
              MESH_TRAIN_TIMEOUT_S, here)
    resume_s = time.perf_counter() - t0
    second = sorted(os.listdir(state_dir))
    check(second == ["step_00000002.pt", "step_00000004.pt"],
          f"phase 20 CLI checkpoints after --resume on --mesh_model 2: {second}")
    samples = os.path.join(tmp, "samples_mesh.txt")
    t0 = time.perf_counter()
    gen_cli.main(["--data_path", paths["test"], "--model_path", save,
                  "--tokenizer_path", paths["vocab"], "--token_emb_path", paths["emb"],
                  "--batch_size", "4", "--n_samples", "2", "--save_samples",
                  "--save_samples_path", samples], mcfg=mcfg, dcfg=dcfg)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    with open(samples, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == 4 and all(ln.strip() for ln in lines),
          f"phase 20 generate CLI on the mesh save path wrote {lines}")
    return dict(zero1_epoch_s=zero1_s, resume_tp_s=resume_s, generate_s=gen_s,
                checkpoints=second)


def phase_mesh_train(out, gpu, paths, tmp):
    """Phase 20: training over the mesh (see the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    here = os.path.abspath(__file__)
    runs, lines = {}, []
    for nproc, names in MESH_TRAIN_JOBS:
        job_dir = os.path.join(tmp, f"mesh_train_job{nproc}")
        os.makedirs(job_dir, exist_ok=True)
        spec_path = os.path.join(job_dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(dict(runs=list(names), out=job_dir), f)
        t0 = time.perf_counter()
        _torchrun(nproc, [*MESH_TRAIN_CMD, spec_path], MESH_TRAIN_TIMEOUT_S,
                  os.path.dirname(here))
        job_s = time.perf_counter() - t0
        got = []
        for r in range(nproc):
            with open(os.path.join(job_dir, f"rank{r}.json")) as f:
                got.append(json.load(f))
        for name in names:
            per_rank = [g["runs"][name] for g in got]
            m = dict(per_rank[0], job_s=job_s, backend=got[0]["backend"],
                     step_ms_ranks=[p["step_ms"] for p in per_rank],
                     peak_memory_gib_ranks=[p["peak_memory_gib"] for p in per_rank],
                     moment_bytes_ranks=[p["moment_bytes"] for p in per_rank])
            for p in per_rank[1:]:
                check(p["launches"] == m["launches"] and p["losses"] == m["losses"],
                      f"phase 20 {name}: the ranks launched or reported differently")
            if "kernel_lines" in m:
                m["kernel_lines_ranks"] = [p["kernel_lines"] for p in per_rank]
            runs[name] = m
            f32 = m.get("f32", {})
            lines.append(
                f"{name} {MESH_TRAIN_RUNS[name][1]} ({m['backend']}, {m['rows']} rows a "
                f"rank): step {m['step_ms']:.1f} ms, loss {m['losses'][0]:.4f} -> "
                f"{m['losses'][-1]:.4f}, launches a rank "
                f"{dict((k, v) for k, v in m['launches'].items() if v)}, collectives a "
                f"step {m['collectives_per_step']} "
                f"({sum(m['collective_mb_per_step'].values()):.0f} MB) under "
                f"{m['remat_policy']}"
                + (f" ({m['collectives_per_step_full']} under full)"
                   if m["collectives_per_step_full"] else "") + ", "
                f"{sum(m['collective_ms_timed_step'].values()):.1f} ms of a "
                f"{m['timed_step_ms']:.1f} ms synchronized step, peak "
                f"{max(m['peak_memory_gib_ranks']):.2f} GiB, moments "
                f"{m['moment_bytes'] / 2 ** 20:.0f} MiB a rank"
                + (f"; f32 vs one card: loss {f32['loss_abs_err']:.2g}, grads "
                   f"{f32['grad_max_abs_err']:.2g}, params {f32['params_max_abs_err']:.2g}, "
                   f"mu {f32['mu_max_abs_err']:.2g}, nu {f32['nu_max_abs_err']:.2g}"
                   if "loss_abs_err" in f32 else "")
                + ("; kernels at the shard shapes = plain: " + " | ".join(m["kernel_lines"])
                   if "kernel_lines" in m else ""))
    check(runs["zero1"]["moment_bytes"] <= 0.51 * runs["dp"]["moment_bytes"],
          "phase 20: ZeRO-1's moments are not half of DP's")
    cli = _mesh_train_cli(paths, tmp)
    wall = time.perf_counter() - t_phase
    out["mesh_train"] = dict(runs=runs, cli=cli, phase_s=wall)
    torch.cuda.synchronize()
    print(f"phase 20 training over the mesh ({torch.cuda.device_count()} card(s), on "
          f"{gpu}, {wall:.1f} s; global batch {MESH_TRAIN_B} bf16, {MESH_TRAIN_F32_B} "
          f"f32): ok; " + "; ".join(lines)
          + f"; train CLI under torchrun (2 layers): --mesh_data 2 --zero1 epoch "
          f"{cli['zero1_epoch_s']:.1f} s, --resume on --mesh_model 2 "
          f"{cli['resume_tp_s']:.1f} s, single-device generate on its save path "
          f"{cli['generate_s']:.1f} s")
    return {name: m["launches"] for name, m in runs.items()}


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


# the kernels the sharded path runs (phase 19)
MESH_KERNELS = ("decode_attention_int8_append", "decode_attention_fp_append",
                "fused_gru", "decode_block_fused")


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
    ap.add_argument("--mesh-train-only", action="store_true",
                    help="phase 1 (the build), then phase 20 (training over the "
                         "mesh) alone: no kernels line")
    ap.add_argument("--quality-only", action="store_true",
                    help="phase 1 (the build), then phase 22 (the quality loop) "
                         "alone: no kernels line")
    ap.add_argument("--mesh-job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-train-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mmtg_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.mesh_job:  # one rank of phase 19, started by phase_mesh
        return mesh_job(args.mesh_job)
    if args.mesh_train_job:  # one rank of phase 20, started by phase_mesh_train
        return mesh_train_job(args.mesh_train_job)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    phase_build(out, args.build_serial)
    gpu = gpu_line()
    out["gpu"] = gpu
    if args.mesh_train_only or args.quality_only:
        tmp = tempfile.mkdtemp(prefix="mmtg_chip_smoke_")
        try:
            if args.mesh_train_only:
                phase_mesh_train(out, gpu, _cli_fixtures(tmp, model_configs()[1]), tmp)
            else:
                phase_quality(out, gpu, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _write_json(args.json, out)
        print(f"gpu: {gpu}")
        return 0
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
        launches["remat"] = phase_remat(out, gpu)
        phase_packed_cli(out, paths, tmp)
        phase_channels(out, gpu)
        phase_forward_infer(out, gpu)
        phase_english(out, gpu, tmp)
        phase_predict(out, gpu, paths, tmp)
        launches["quality"] = phase_quality(out, gpu, tmp)
        launches["mesh"] = phase_mesh(out, gpu, paths, tmp)
        launches["mesh_train"] = phase_mesh_train(out, gpu, paths, tmp)
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
        if name in TRAIN_FNS:
            # each remat policy's run on its cells (phase 21), fwd + bwd
            extra["remat_launches"] = {
                f"{cell} {run}": c[f"{name}_fwd"] + c[f"{name}_bwd"]
                for cell, runs in launches["remat"].items()
                for run, c in runs.items() if c[f"{name}_fwd"]}
            check(bool(extra["remat_launches"]),
                  f"{name} was not launched on the remat policies' path (phase 21)")
            # each mesh run's steps (phase 20), fwd + bwd launches of one rank
            extra["mesh_train_launches_per_rank"] = {
                run: counts_[f"{name}_fwd"] + counts_[f"{name}_bwd"]
                for run, counts_ in launches["mesh_train"].items()
                if counts_[f"{name}_fwd"]}
            check(bool(extra["mesh_train_launches_per_rank"]),
                  f"{name} was not launched on the mesh train path (phase 20)")
            extra["mesh_shard_shapes"] = {
                k: {x: v[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms",
                                      "max_abs_err")}
                for run in out["mesh_train"]["runs"].values()
                for k, v in run.get("kernels", {}).items() if k.startswith(name + "|")}
        if name in MESH_KERNELS:
            # each mesh's runs (phase 19), launches of one rank
            extra["mesh_launches_per_rank"] = {
                mesh: sum(run["launches"][name] for run in runs.values()
                          if "launches" in run)
                for mesh, runs in launches["mesh"].items()}
            check(any(extra["mesh_launches_per_rank"].values()),
                  f"{name} was not launched on the mesh path (phase 19)")
        # every train run and generate call of the quality loop (phase 22)
        q = (launches["quality"][f"{name}_fwd"] + launches["quality"][f"{name}_bwd"]
             if name in TRAIN_FNS else launches["quality"][name])
        if q:
            extra["quality_loop_launches"] = q
        check(n > 0, f"{name} was not launched on its path ({path})")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dtype="bfloat16",
            f32_max_abs_err=f32["max_abs_err"], **extra))
    out["kernels"] = kernels
    out["total_s"] = time.perf_counter() - t_start
    _write_json(args.json, out)
    print(f"chip_smoke: 22 phases in {out['total_s']:.1f} s")
    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
