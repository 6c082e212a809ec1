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
     kernel's ptxas line and launch plan beside its times; then the
     batch-invariant kernels (no TPU counterpart): the product
     (ops/matmul) on each of the main path's shapes (a decode step's four
     products a layer and its LM head, the projector's two, the prefill's
     per-head probabilities @ values, the beta attention's K = 3 mix), the
     LayerNorm (ops/layer_norm) in both its forms (alone, and with the
     decode step's residual h + y + bias in the same launch: h_new bit-equal
     to the eager adds) and the prefix sum (ops/cumsum) on the
     nucleus's, at M = 8, 64, 512 rows in bf16 (the product in f32 too, at
     M = 64 on both weight layouts; qkv and mlp_proj also at the B = 512
     prefill's 8192 rows), each against its plain version, a row alone holding
     the same bits, and timed beside the library call it replaces and its
     bound; and the product's two tensor-parallel modes (partial_out,
     acc_in) on the row-parallel shards of tp = 2 (attn_proj [M, 384] @
     [384, 768], mlp_proj [M, 1536] @ [1536, 768]) at the same M (f32 at
     64), against their plain version, the two ranks' chain the whole
     product's bits, timed beside F.linear on the shard;
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
 15. the LSTM, RNN and TRM encoder channels at full width, the decoder cut
     to 2 layers: for each,
     decoding.generate at B=64 with row seeds (bf16, int8 cache: 440
     launches of the int8-append kernel, none of the GRU kernel, every
     channel product and LayerNorm through the batch-invariant kernels), one
     of its rows decoded alone giving the same 220 tokens, teacher-forced f32
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
 19. the sharded serving path over torch.distributed, full width cut to 2
     layers, B=64, 220 tokens, ranks started as child processes by `python -m
     torch.distributed.run` (each launch with its own time limit; a failed
     rank fails the phase) on the cards there are (the backend by the rule
     of parallel/mesh.py: gloo when ranks share a card): on the meshes
     (2, 1), (1, 2) and (2, 2), generate_sharded in bf16 and in f32 over
     three sentence frames (wall, launches a rank, the row-parallel products'
     ordered folds a step and their time beside an all-reduce's, TP ranks'
     tokens checked equal), an int8 cache and
     (DP-only) the whole-step kernel on two sentence frames,
     generate_stream_sharded = generate_sharded token for token (f32),
     f32 step logits of the sharded decode on forced tokens
     within 1e-4 of the single-device step, every row (bf16 over 220 tokens,
     f32 over three frames) equal to single-device generate's (checked: the
     shares must be 1.0), each row-parallel product's fold over the model
     group bit-equal to one device's product, and per rank the decode
     kernels, the GRU and the product's two modes at the shard shapes
     against their plain versions; then
     `python -m mmtg_tpu_torch.serve` on a (2, 2) mesh under torchrun (f32,
     all 12 layers, buckets 4,8): a window of three one-shot and one streamed request over
     HTTP, /reload, one more request, each held against generate_sharded on
     the mesh, SIGTERM to rank 0 and every rank exiting 0.
 20. training over the mesh under torchrun (full width cut to 2 layers):
     data, tensor and pipeline
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
 23. the serving and latency tools (mmtg_tpu_torch/tools/) through their
     ``run`` at full width in bf16, one seeded model: bench_serve (64
     closed-loop clients, 256 requests, buckets 8-64, int8 cache) on the
     per-layer path with 3 solo requests and on the whole-step kernel, each
     path's saturation capacity C in requests/s; bench_stream, 3 streams
     each equal to its batched response, then 16 concurrent streams
     (buckets 8,16, 2 rounds) sharing windows; soak_serve, 12 s of open-loop
     Poisson arrivals at 0.5 C (no rejection, nothing lost) and at 2 C with
     max_queue_depth 128 (shedding, nothing lost, the backlog within the
     queue plus three windows); bench_serve_http with JSON and npz bodies
     at buckets 8,16,32,64 (every response equal to submit's with its seed,
     whichever bucket its window took); fixed_cost_sweep at B=64 over four
     lengths, whose F bench_latency adds to every row's memory floor
     (batches 1,8,32 x weights model,int8; each wall at least its floor).
     Every scenario's launches are held against its windows or calls.
 24. the trace tools (mmtg_tpu_torch/tools/), each run as a user runs it, a
     process of its own at full width in bf16: trace_decode at B=512 (int8
     cache, the per-layer step) and at B=64 on the whole-step kernel
     (--attn-impl fused), trace_train at B=256 (3 steps); each trace read
     back by trace_train --parse-only --json: the categories sum to the busy
     total (within 0.1 ms a step), busy is within the wall, and the events
     of each of the port's kernels equal the launches reckoned for the path
     (2640 decode attention and 2 GRU; 220 whole-step and 2 GRU; 36 of each
     train-attention kernel under the policy "auto"); each trace's busy
     share, categories and top 10 ops are printed.
 25. batch invariance (tools/batch_invariance.py) on phase 3's model, bf16:
     one (request, seed) decoded alone and at B = 8, 16, 32, 64, at the first,
     the middle and the last row among random neighbours, 220 tokens, on the
     per-layer path (int8 cache and bf16 cache) and the whole-step kernel:
     each path's first differing step, "none" the pass; the op probe of every
     op the repair touched (the decode-attention kernel, the whole-step
     kernel, the batch-invariant product on the LM head and the prefill's
     products, the prefix sum, the stable top-k, the sampler, and every
     encoder channel kind: the LSTM, RNN, 2-layer GRU and TRM stacks at full
     width, in bf16 and in f32): a row's bits
     at each M equal its bits alone; on a mismatch the whole probe's list is printed and the phase
     fails. Then tools/parity_check on a synthetic full-size reference .pth
     (two batches of 4): the train, infer and decode surfaces through the
     kernels in f32 within 5e-4 of the port's plain path on the CPU, bf16
     beside.
(Phases 11-14 run after phase 4, then phases 23 and 24, phase 21 after phase 9,
phases 15-18 after phase 10, then phases 22 and 25 with phases 19 and 20
beside them, each in a thread of its own: their torchrun jobs mostly start
processes and wait on gloo, and phases 22 and 25 have no speed metric; their
walls are taken side by side, and phase 20's one in-process call waits for
the counted runs of phases 22 and 25.)
Where a train step runs with remat and the policy "auto" (phases 6-10, 15,
17, 20), its attention launches are asserted for the policy "auto" resolves
to (train._resolve_remat_policy): the kept qkv and context at these batches,
a forward and a backward a layer.
It then prints its total time and each phase's seconds, the card's name
and power limit, the
kernels' JSON line (with each mesh kernel's launches a rank on phase 19's
meshes) and, last, the device JSON line.
--profile adds a torch.profiler kernel-time split of one B=64 train step
and of one packed train step, in phase 24's categories;
--build-serial also times one nvcc process over all sources beside the
parallel build; --kernels-only stops after phase 2 (to time another
checkout's kernels with this script's measurements); --mesh-train-only runs
phase 1 and phase 20 alone, --quality-only phase 1 and phase 22,
--serving-only phase 1 and phase 23, --trace-only phase 1 and phase 24.
Without a
CUDA device it exits non-zero and prints no result. Every process it
starts dies with its parent, and whatever is still running when the script
ends, also on SIGTERM, is stopped and reaped before it exits.
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
import threading
import time

L, B_ATT, T_CAP, D, H = 12, 64, 256, 768, 12
POSITIONS = (0, 15, 16, 127, 128, 235)
TIMED_POSITION = 235  # the last decode step: the longest live prefix
GRU_SHAPE = dict(T=5, B=64, I=2048, H=512)
OTHER_BATCHES = (1, 512)  # phase 2 beside B=64: the p50 path and the widest batch
# the benchmark's decode attention (zh-generate-b4096): 4096 rows, every slot
# live, a mid-call and the last position; 4 layers in turn keep it cold
WIDE_BATCH, WIDE_POSITIONS, WIDE_LAYERS = 4096, (126, 235), 4
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (attention, GRU)
LENGTH = 220
# the depth of the paths whose subject is not the decoder's depth: the
# encoder channels (phase 15) and the mesh runs (phases 19 and 20; the
# meshed service keeps all 12 layers), as of the train CLI runs (7, 10, 20)
CUT_DEPTH = 2
# a warm-up decode's length: one sentence frame, every shape of the call but
# the cache's capacity (the port compiles nothing: a warm-up only meets the
# library handles and the allocator)
WARM_LENGTH = 22
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
# the batch-invariant kernels (no TPU counterpart): the product at each of
# the main path's shapes (_matmul_cases), the LayerNorm, and the nucleus's
# prefix sum over the top-k candidates (V = 10; 13317 when top-p filters the
# whole vocabulary) at the decode's row counts; M = 64 is the kernels line's
# shape
INVARIANT_ROWS = (8, 64, 512)
# the prefill's rows at B = 512 (16 positions a row) on qkv and mlp_proj: the
# launch's one-block form with 128-row tiles and many K ranges
PREFILL_ROWS, PREFILL_CASES = 16 * 512, ("qkv", "mlp_proj")
# the product against cuBLAS's, relative to the largest output: bf16 two
# roundings of the output (2^-7; summation order moves the f32 sum by far
# less), f32 the summation order; the prefix sum max-abs on values up to 1
# (and a rounding above it): bf16 one step at 1 (2^-7), f32 the order of
# 13317 adds
MATMUL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CUMSUM_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# LayerNorm against the eager ops, relative to the largest output: bf16 the
# mean's and the output's roundings (a sum in another order may round the mean
# to the next bf16 value: two steps of the output), f32 the summation order
# and rsqrtf's last bit
LN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# the encoder's LayerNorms (models/mmtg.encode_experiences): width and rows
ENCODER_LN_WIDTH = GRU_SHAPE["H"]
ENCODER_LN_ROWS = (GRU_SHAPE["B"], GRU_SHAPE["T"] * GRU_SHAPE["B"])
# phase 25: the batches one (request, seed) is decoded at, and the parity
# check's f32 bound (the JAX tool's)
INVARIANCE_BATCHES = (1, 8, 16, 32, 64)
PARITY_ATOL = 5e-4


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


def depth_cut(n_layer: int):
    """The repo's model cut to ``n_layer`` GPT-2 layers, its width kept."""
    import dataclasses

    mcfg, dcfg = model_configs()
    return dataclasses.replace(mcfg, gpt2=dataclasses.replace(
        mcfg.gpt2, n_layer=n_layer)), dcfg


# ---------------------------------------------------------------------------
# The processes the script starts: torchrun launchers and their ranks. A
# launcher runs each rank in a session of its own, so a rank outlives a
# launcher that is killed; here each of them dies with its parent
# (PR_SET_PDEATHSIG), the script adopts what a dead parent leaves
# (PR_SET_CHILD_SUBREAPER), and, on its way out, stops and reaps every child
# still there, also when it ends on SIGTERM.

PR_SET_PDEATHSIG, PR_SET_CHILD_SUBREAPER = 1, 36
WITH_PARENT = "--with-parent"  # chip_smoke.py --with-parent <module> <its argv>
AFTER = "--after"  # chip_smoke.py --with-parent --after <go file> <module> <argv>


def _prctl(option: int, value: int) -> bool:
    import ctypes

    return ctypes.CDLL(None, use_errno=True).prctl(option, value, 0, 0, 0) == 0


def _die_with_parent() -> None:
    """The kernel SIGKILLs this process when the one that started it ends."""
    import signal

    _prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


def _run_module_with_parent(argv) -> int:
    """``python -m argv[0] argv[1:]`` in this process, which dies with its
    parent (how the script runs torchrun, and torchrun the CLIs). After
    ``--after GO``: first :func:`_ready_to_trace`, then wait until the file
    ``GO`` exists."""
    import runpy

    _die_with_parent()
    if argv[:1] == [AFTER]:
        go, argv = argv[1], argv[2:]
        _ready_to_trace()
        while not os.path.exists(go):
            time.sleep(0.05)
    sys.argv = list(argv)
    runpy.run_module(argv[0], run_name="__main__", alter_sys=True)
    return 0


def _ready_to_trace() -> None:
    """What a trace tool's process pays before any of its work: the imports
    (7-8 s on an H100 host). Phase 24 lets a tool's process do this while
    the tool before it runs. (Not the profiler's own start-up, about 7 s
    more: a second profiler session in one process lost the last kernel
    records of its trace on an H100, so each tool starts its one profiler
    session itself.)"""
    import torch  # noqa: F401
    from torch.profiler import ProfilerActivity, profile  # noqa: F401

    import mmtg_tpu_torch.tools.trace_decode  # noqa: F401
    import mmtg_tpu_torch.tools.trace_train  # noqa: F401
    from mmtg_tpu_torch import decoding, train  # noqa: F401


def module_cmd(module: str, *args: str, after=None) -> tuple:
    """``-m module args`` as a script and its arguments (what torchrun
    takes): this file, run through :func:`_run_module_with_parent` (which
    waits for the file ``after`` first, when given)."""
    gate = (AFTER, after) if after else ()
    return (os.path.abspath(__file__), WITH_PARENT, *gate, module, *args)


def torchrun_cmd(nproc: int, args) -> list:
    """``python -m torch.distributed.run --standalone`` with ``nproc`` ranks,
    each running ``args`` (a script and its flags)."""
    return [sys.executable, *module_cmd("torch.distributed.run"), "--standalone",
            "--nproc_per_node", str(nproc), *args]


def _children() -> dict:
    """{pid: (state, command line)} of this process's children (/proc)."""
    me, found = os.getpid(), {}
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me:
                continue
            with open(f"/proc/{p}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError, ValueError):
            continue
        found[int(p)] = (fields[0], cmd.strip()[:200])
    return found


def _stop_children(grace_s: float = 20.0) -> None:
    """SIGTERM every child still running (after PR_SET_CHILD_SUBREAPER, also
    every orphaned descendant), SIGKILL what outlives ``grace_s``, reap them
    all, and name on stderr what had to be stopped."""
    import signal

    stopped, sig = {}, signal.SIGTERM
    deadline = time.monotonic() + grace_s
    while True:
        kids = _children()
        for pid, (state, cmd) in kids.items():
            if state != "Z" and (pid not in stopped or sig == signal.SIGKILL):
                stopped.setdefault(pid, cmd)
                try:
                    os.kill(pid, sig)
                except ProcessLookupError:
                    pass
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
        if not kids or time.monotonic() > deadline + 10:
            break
        if time.monotonic() > deadline:
            sig = signal.SIGKILL
        time.sleep(0.1)
    if stopped:
        print(f"chip_smoke: stopped {len(stopped)} process(es) still running: "
              + "; ".join(f"{pid} {cmd}" for pid, cmd in stopped.items()),
              file=sys.stderr)


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


def _decode_attention_ptxas():
    """Registers and spill bytes (stores, loads) of every instantiation of
    csrc/decode_attention.cu's kernel (dtype, cache kind, int4 pair,
    append), from the build log."""
    import re

    from mmtg_tpu_torch.kernels import _build

    kinds = {"0": "fp", "1": "int8", "2": "int4"}
    seen, current = {}, None
    with open(_build.library_path() + ".log") as f:
        for ln in f:
            if "Compiling entry function" in ln or "Function properties for" in ln:
                m = re.search(r"decode_attention_kernelI(\w+?)Li(\d)ELb([01])ELb([01])E", ln)
                current = None if m is None else (
                    f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'} {kinds[m.group(2)]}"
                    f"{' pair' if m.group(4) == '1' else ''}{' append' if m.group(3) == '1' else ''}")
                continue
            if current is None:
                continue
            entry = seen.setdefault(current, {})
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                entry["spill"] = (int(m.group(1)), int(m.group(2)))
    check(seen, "decode_attention: no ptxas report in the build log")
    return [f"{k}: {v.get('registers')} registers, spills {v.get('spill')}"
            for k, v in sorted(seen.items())]


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
        # port's own per-layer step, 12 layers and the last MLP residual it
        # leaves pending (the fused kernel adds it too)
        def per_layer_step():
            hh, (y, bias) = gpt2._decode_layers(
                p, cfg, cache, h, TIMED_POSITION, mask, True, "int8", H)
            return hh + y + bias

        per_layer_ms = device_ms(per_layer_step, reps=11, warmup=2)
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
            f"{ms:.4f} ms plain {plain_ms:.4f} ms per-layer step (the port's own: 12 layers "
            f"and the last residual add) {per_layer_ms:.4f} ms bound "
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

    reps = 25 if B == B_ATT else 11  # the main path's batch, then B = 1 and 512
    ms = device_ms(lambda: run_kernel(caches, scales, TIMED_POSITION,
                                      state["layer"]), reps=reps, between=rotate)
    plain_ms = device_ms(lambda: run_plain(caches, scales, TIMED_POSITION,
                                           state["layer"]), reps=reps, between=rotate)
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

        library_ms = device_ms(run_library, reps=reps, between=rotate)
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


def _decode_at_width(results, da, gen):
    """decode_attention_int8_append at the benchmark's batch (WIDE_BATCH rows,
    bf16, every slot live as in a generate call's cache): ctx within TOL of
    the plain version and the appended bytes and scales bit for bit at each
    position of WIDE_POSITIONS, then the device time beside the bound.
    Stored under (name, "bfloat16", "B<B>", "pos<p>")."""
    import torch

    name, B, dtype = "decode_attention_int8_append", WIDE_BATCH, torch.bfloat16
    q, k_new, v_new = (torch.randn(B, D, generator=gen, device=DEVICE).to(dtype)
                       for _ in range(3))
    mask = torch.ones(B, T_CAP, device=DEVICE, dtype=torch.int32)
    base = [torch.randint(-127, 128, (WIDE_LAYERS, B, T_CAP, D), generator=gen,
                          device=DEVICE, dtype=torch.int8) for _ in range(2)]
    base += [torch.rand(WIDE_LAYERS, B, T_CAP, generator=gen, device=DEVICE) * 0.02 + 0.005
             for _ in range(2)]
    lines = []
    for pos in WIDE_POSITIONS:
        kc = [c.clone() for c in base]
        ctx = da.decode_attention_int8_append(q, k_new, v_new, *kc, mask, pos, 1, n_head=H)
        ref = da.decode_attention_append_plain(q, k_new, v_new, base[0], base[1], mask,
                                               pos, 1, H, *base[2:])
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(kc, base)),
              f"{name} B={B} pos {pos}: a cache or scale tensor differs from the plain version")
        err = (ctx.float() - ref.float()).abs().max().item()
        check(err <= TOL["bfloat16"][0], f"{name} B={B} pos {pos}: ctx max-abs {err:.3g}")
        del kc, ctx, ref
        state = {"layer": 0}

        def rotate(r):
            state["layer"] = r % WIDE_LAYERS

        ms = device_ms(lambda: da.decode_attention_int8_append(
            q, k_new, v_new, *base, mask, pos, state["layer"], n_head=H), reps=11,
            between=rotate)
        W = pos + 1  # every slot live: q, the k/v rows and scales, mask, ctx, the appends
        nbytes = (B * D * 2 + 2 * B * W * D + 2 * 4 * B * W + 4 * B * W + B * D * 2
                  + 2 * B * D * 2 + 2 * B * D + 2 * 4 * B)
        key = (name, "bfloat16", f"B{B}", f"pos{pos}")
        results[key] = dict(max_abs_err=err, ms=ms, **bound(nbytes, 4.0 * B * W * D,
                                                            "bfloat16"))
        share = 100.0 * results[key]["bound_ms"] / ms
        lines.append(f"{name}[bfloat16 B={B} pos {pos}, all live] err {err:.3g} kernel "
                     f"{ms:.4f} ms bound {results[key]['bound_ms']:.4f} ms ({share:.1f}%)")
    del base
    torch.cuda.empty_cache()
    return lines


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


# the batch-invariant product's shapes on the main path at M rows (x [M, K]
# @ w [K, N], or batched over Z): name -> (Z, M, K, N, bias, w read
# transposed). A decode step's four products a layer (48 of its 51) and
# its LM head (the tied wte.T: the [N, K] layout); the step embedding's two
# projector products (2048 -> 512 -> 768, the other 2 of a step's 51, and the
# prefill's); the prefill's probabilities @ values (per head, bf16; P + 1 = 16
# positions) and the beta attention's 3-way mix (K = 3) from the batched form
def _matmul_cases(M):
    P1, heads, hd, steps, enc_h = 16, 12, D // 12, 5, 512
    return {
        "qkv": (None, M, D, 3 * D, True, False),
        "attn_proj": (None, M, D, D, False, False),
        "mlp_fc": (None, M, D, 4 * D, True, False),
        "mlp_proj": (None, M, 4 * D, D, False, False),
        "lm_head": (None, M, D, 13317, False, True),
        "proj_in": (None, M, 2048, 512, True, False),
        "proj_out": (None, M, 512, D, True, False),
        "prefill_pv": (M * heads, P1, P1, hd, False, False),
        "beta_mix": (M * steps, 1, 3, enc_h, False, False),
    }


def _matmul_plan(mm, K, N, dtype):
    """The plan ops/matmul runs for the shape, as text ("" where the tree's
    ops/matmul has none: a parent's, timed with this script)."""
    import torch

    if not hasattr(mm, "plan"):
        return ""
    pl = mm.plan(K, N, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    if pl.path == "small":
        return " plan small"
    return f" plan {pl.bn}x{len(pl.ranges)} ranges of {pl.spr} stages, {pl.slots} in flight"


def _matmul_vs_plain(results, dtype, M, gen, case):
    """The batch-invariant product (ops/matmul, the kernel) on one of the
    main path's shapes (:func:`_matmul_cases`) vs its plain version
    (``torch.matmul``: cuBLAS) within MATMUL_TOL of the largest output; the
    first and the last row (of the batched form: batch entry) computed alone
    give the same bits (the point of the kernel); device times (median of 11)
    of the kernel, the plain version and the library call of the same
    function (``F.linear``; ``torch.bmm`` for the batched form), and the
    bound. Stored under ("matmul", dtype, case, "M<M>")."""
    import torch

    from mmtg_tpu_torch.ops import matmul as mm

    dname = str(dtype).split(".")[1]
    Z, rows, K, N, has_bias, trans = _matmul_cases(M)[case]
    lead = () if Z is None else (Z,)
    x = torch.randn(*lead, rows, K, generator=gen, device=DEVICE).to(dtype)
    w = (torch.randn(*lead, *((N, K) if trans else (K, N)), generator=gen, device=DEVICE)
         * 0.02).to(dtype)
    w = w.T if trans else w  # the tied LM head's wte.T: a transposed view
    b = (torch.randn(N, generator=gen, device=DEVICE) * 0.1).to(dtype) if has_bias else None
    if Z is None:
        run = lambda a, ww: mm.matmul(a, ww, b)  # noqa: E731
        plain = lambda a, ww: mm.matmul_plain(a, ww, b)  # noqa: E731
        library = lambda: torch.nn.functional.linear(x, w.T, b)  # noqa: E731
        first, last = (x[:1], w), (x[-1:], w)
    else:
        run, plain = mm.batched_matmul, mm.matmul_plain
        library = lambda: torch.bmm(x, w)  # noqa: E731
        first, last = (x[:1], w[:1]), (x[-1:], w[-1:])
    before = mm.matmul.launches
    y = run(x, w)
    ref = plain(x, w)
    alone = (run(*first)[0], run(*last)[0])
    torch.cuda.synchronize()
    check(mm.matmul.launches == before + 3, "matmul: not one launch a call")
    check(y.shape == ref.shape and y.dtype == dtype, f"matmul {case} shape/dtype")
    what = f"matmul {case} {dname} M={M}"
    check(torch.equal(alone[0], y[0]) and torch.equal(alone[1], y[-1]),
          f"{what}: a {'row' if Z is None else 'batch entry'} alone differs from the "
          f"same one among {M}")
    e = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(e <= MATMUL_TOL[dname] * scale, f"{what}: max-abs {e:.3g} > "
          f"{MATMUL_TOL[dname]} x {scale:.3g}")
    ms = device_ms(lambda: run(x, w), reps=11, warmup=2)
    plain_ms = device_ms(lambda: plain(x, w), reps=11, warmup=2)
    library_ms = device_ms(library, reps=11, warmup=2)
    z = 1 if Z is None else Z
    key = ("matmul", dname, case, f"M{M}")
    results[key] = dict(
        max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound((x.numel() + w.numel() + y.numel() + (N if has_bias else 0))
                * x.element_size(), 2.0 * z * rows * K * N, dname))
    shape = f"{'' if Z is None else f'{Z}x'}[{rows},{K}]@[{K},{N}]{'+b' if has_bias else ''}"
    return (f"matmul[{case} {dname} M={M} {shape}{_matmul_plan(mm, K, N, dtype)}] err "
            f"{e:.3g} (largest {scale:.3g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {library_ms:.4f} ms bound {results[key]['bound_ms']:.4f} ms")


# the row-parallel products' shards on two ranks (tp = 2): (K, N) of the full
# weight; each rank holds [K / 2, N]
TP_SHARDS = {"attn_proj": (D, D), "mlp_proj": (4 * D, D)}
TP_MODES = ("partial_out", "acc_in")  # rank 0's, the last rank's


def _matmul_tp_vs_plain(results, dtype, M, gen, case, mode, timed=True):
    """One mode of the batch-invariant product on a row-parallel shard
    (:data:`TP_SHARDS`, tp = 2, the full weight's plan: ops/matmul.
    shard_plan): ``partial_out`` (rank 0: the f32 fold, unrounded) or
    ``acc_in`` (rank 1: the fold continued from rank 0's partial, rounded)
    against its plain version (the f32 partial within 1e-5 of its largest
    entry; the rounded product within MATMUL_TOL), a row alone the same
    bits, the two ranks' chain the bits of the whole weight's product; with
    ``timed``, device times (median of 7) of the kernel, the plain version
    and ``F.linear`` on the shard, and the bound. Stored under ("matmul",
    dtype, "<case>_tp2_<mode>", "M<M>")."""
    import torch

    from mmtg_tpu_torch.ops import matmul as mm

    dname = str(dtype).split(".")[1]
    K, N = TP_SHARDS[case]
    k = K // 2
    x = torch.randn(M, K, generator=gen, device=DEVICE).to(dtype)
    w = (torch.randn(K, N, generator=gen, device=DEVICE) * 0.02).to(dtype)
    x0, x1, w0, w1 = x[:, :k].contiguous(), x[:, k:].contiguous(), w[:k], w[k:]
    acc = mm.matmul(x0, w0, partial_out=True, plan_shape=(K, N))
    if mode == "partial_out":
        xs, ws, kw = x0, w0, dict(partial_out=True, plan_shape=(K, N))
    else:
        xs, ws, kw = x1, w1, dict(acc_in=acc, plan_shape=(K, N))
    run = lambda a, ww, **o: mm.matmul(a, ww, **{**kw, **o})  # noqa: E731
    y = run(xs, ws)
    ref = mm.matmul_plain(xs, ws, **kw)
    what = f"matmul {case} tp2 {mode} {dname} M={M}"
    check(y.dtype == (torch.float32 if mode == "partial_out" else dtype)
          and y.shape == ref.shape, f"{what}: shape / dtype")
    e = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-5 if mode == "partial_out" else MATMUL_TOL[dname]
    check(e <= tol * scale, f"{what}: max-abs {e:.3g} > {tol} x {scale:.3g}")
    r = M - 1
    one = run(xs[r:r + 1], ws, **({"acc_in": acc[r:r + 1]} if mode == "acc_in" else {}))
    check(torch.equal(one[0], y[r]), f"{what}: the last row alone differs")
    if mode == "acc_in":  # the two ranks' chain against one device's product
        check(torch.equal(y, mm.matmul(x, w)),
              f"{what}: the chain of two K halves is not the whole product's bits")
    torch.cuda.synchronize()
    key = ("matmul", dname, f"{case}_tp2_{mode}", f"M{M}")
    line = (f"matmul[{case} tp2 {mode} {dname} M={M} [{M},{k}]@[{k},{N}]"
            f"{_matmul_plan(mm, K, N, dtype)} of the full weight] err {e:.3g} (largest "
            f"{scale:.3g}){', chain = whole' if mode == 'acc_in' else ''}")
    results[key] = dict(max_abs_err=e)
    if not timed:
        return line
    ms = device_ms(lambda: run(xs, ws), reps=7, warmup=2)
    plain_ms = device_ms(lambda: mm.matmul_plain(xs, ws, **kw), reps=7, warmup=2)
    library_ms = device_ms(lambda: torch.nn.functional.linear(xs, ws.T), reps=7, warmup=2)
    nbytes = (xs.numel() + ws.numel()) * xs.element_size() + y.numel() * y.element_size() \
        + (acc.numel() * 4 if mode == "acc_in" else 0)
    results[key].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        **bound(nbytes, 2.0 * M * k * N, dname))
    return (f"{line} kernel {ms:.4f} ms plain {plain_ms:.4f} ms F.linear "
            f"{library_ms:.4f} ms bound {results[key]['bound_ms']:.4f} ms")


def _cumsum_vs_plain(results, dtype, R, V, gen):
    """The batch-invariant prefix sum (ops/cumsum, the kernel) over ``R``
    rows of ``V`` sorted probabilities vs its plain version (``torch.cumsum``
    accumulating in f32, rounded once an entry) within CUMSUM_TOL; a row
    alone gives the same bits; device times of the kernel, the plain version
    and ``torch.cumsum`` on x itself (the library call the port replaced),
    and the bound. Stored under ("row_cumsum", dtype, "M<R>") for V = 10,
    with "V<V>" appended else."""
    import torch

    from mmtg_tpu_torch.ops import cumsum as cs

    dname = str(dtype).split(".")[1]
    x = torch.softmax(torch.randn(R, V, generator=gen, device=DEVICE), -1)
    x = x.sort(dim=-1, descending=True).values.to(dtype)
    before = cs.row_cumsum.launches
    y = cs.row_cumsum(x)
    ref = cs.row_cumsum_plain(x)
    alone = cs.row_cumsum(x[-1:])[0]
    torch.cuda.synchronize()
    check(cs.row_cumsum.launches == before + 2, "row_cumsum: not one launch a call")
    check(torch.equal(alone, y[-1]),
          f"row_cumsum {dname} R={R}: a row alone differs from the same row among {R}")
    e = (y.float() - ref.float()).abs().max().item()
    check(e <= CUMSUM_TOL[dname], f"row_cumsum {dname} R={R} V={V}: max-abs {e:.3g} > "
          f"{CUMSUM_TOL[dname]}")
    ms = device_ms(lambda: cs.row_cumsum(x), reps=11, warmup=2)
    plain_ms = device_ms(lambda: cs.row_cumsum_plain(x), reps=11, warmup=2)
    library_ms = device_ms(lambda: torch.cumsum(x, dim=-1), reps=11, warmup=2)
    key = ("row_cumsum", dname, f"M{R}") + (() if V == 10 else (f"V{V}",))
    results[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        **bound(2 * R * V * x.element_size(), R * V, dname))
    return (f"row_cumsum[{dname} R={R} V={V}] err {e:.3g} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library (torch.cumsum) {library_ms:.4f} ms bound "
            f"{results[key]['bound_ms']:.4f} ms")


def _layer_norm_vs_plain(results, dtype, M, gen, width=D):
    """The batch-invariant LayerNorm (ops/layer_norm, the kernel) over ``M``
    rows of ``width`` (the model's, or the encoder's ENCODER_LN_WIDTH) vs its
    plain version (the eager torch ops) within LN_TOL of the largest output;
    a row alone gives the same bits; device times of the kernel, the plain
    version and ``F.layer_norm`` (the library call of the same function),
    and the bound. Stored under ("layer_norm", dtype, "M<M>"), with "D<width>"
    after it at another width than the model's."""
    import torch

    from mmtg_tpu_torch.ops import layer_norm as ln

    dname = str(dtype).split(".")[1]
    x = (torch.randn(M, width, generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(width, generator=gen, device=DEVICE)).to(dtype)
    b = (0.1 * torch.randn(width, generator=gen, device=DEVICE)).to(dtype)
    key = ("layer_norm", dname, f"M{M}") + (() if width == D else (f"D{width}",))
    what = f"layer_norm {dname} M={M} D={width}"
    before = ln.layer_norm_rows.launches
    y = ln.layer_norm_rows(x, g, b, 1e-5)
    ref = ln.layer_norm_plain(x, g, b, 1e-5)
    alone = ln.layer_norm_rows(x[-1:], g, b, 1e-5)[0]
    torch.cuda.synchronize()
    check(ln.layer_norm_rows.launches == before + 2, f"{what}: not one launch a call")
    check(torch.equal(alone, y[-1]),
          f"{what}: a row alone differs from the same row among {M}")
    e = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(e <= LN_TOL[dname] * scale, f"{what}: max-abs {e:.3g} > "
          f"{LN_TOL[dname]} x {scale:.3g}")
    ms = device_ms(lambda: ln.layer_norm_rows(x, g, b, 1e-5), reps=11, warmup=2)
    plain_ms = device_ms(lambda: ln.layer_norm_plain(x, g, b, 1e-5), reps=11, warmup=2)
    library_ms = device_ms(lambda: torch.nn.functional.layer_norm(x, (width,), g, b, 1e-5),
                           reps=11, warmup=2)
    e_sz = x.element_size()
    results[key] = dict(
        max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound((2 * M * width + 2 * width) * e_sz, 8.0 * M * width, dname))
    return (f"layer_norm[{dname} M={M} D={width}] err {e:.3g} (largest {scale:.3g}) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{results[key]['bound_ms']:.4f} ms")


def _add_layer_norm_vs_plain(results, dtype, M, gen):
    """The residual form (ops/layer_norm.add_layer_norm_rows: the decode
    step's ``h + y + bias`` and the LayerNorm after it in one launch) over
    ``M`` rows of the model's width vs its plain version (the eager adds,
    then ``layer_norm_plain``): ``out`` within LN_TOL of the largest plain
    output, ``h_new`` bit-equal to the eager adds, the first and the last
    row alone the same bits, one launch a call; device times of the kernel,
    the plain version, the library yardstick (the eager adds then
    ``F.layer_norm``, timed as one call), and the bound. Stored under
    ("add_layer_norm", dtype, "M<M>")."""
    import torch

    from mmtg_tpu_torch.ops import layer_norm as ln

    dname = str(dtype).split(".")[1]
    h = (torch.randn(M, D, generator=gen, device=DEVICE) * 2 + 0.5).to(dtype)
    y = torch.randn(M, D, generator=gen, device=DEVICE).to(dtype)
    bias, b = ((0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
               for _ in range(2))
    g = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).to(dtype)
    run = lambda hh, yy: ln.add_layer_norm_rows(hh, yy, bias, g, b, 1e-5)  # noqa: E731
    before = ln.layer_norm_rows.launches
    h_new, out = run(h, y)
    ref_h, ref = ln.add_layer_norm_plain(h, y, bias, g, b, 1e-5)
    alone = [run(h[r:r + 1], y[r:r + 1]) for r in (0, M - 1)]
    torch.cuda.synchronize()
    what = f"add_layer_norm {dname} M={M}"
    check(ln.layer_norm_rows.launches == before + 3, f"{what}: not one launch a call")
    check(torch.equal(h_new, ref_h), f"{what}: h_new differs from the eager h + y + bias")
    for r, (ah, ao) in zip((0, M - 1), alone):
        check(torch.equal(ah[0], h_new[r]) and torch.equal(ao[0], out[r]),
              f"{what}: row {r} alone differs from the same row among {M}")
    e = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(e <= LN_TOL[dname] * scale, f"{what}: max-abs {e:.3g} > {LN_TOL[dname]} x "
          f"{scale:.3g}")
    ms = device_ms(lambda: run(h, y), reps=11, warmup=2)
    plain_ms = device_ms(lambda: ln.add_layer_norm_plain(h, y, bias, g, b, 1e-5),
                         reps=11, warmup=2)
    library_ms = device_ms(lambda: torch.nn.functional.layer_norm(
        h + y + bias, (D,), g, b, 1e-5), reps=11, warmup=2)
    e_sz = h.element_size()
    key = ("add_layer_norm", dname, f"M{M}")
    results[key] = dict(
        max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound((4 * M * D + 3 * D) * e_sz, 10.0 * M * D, dname))
    return (f"add_layer_norm[{dname} M={M} D={D}] err {e:.3g} (largest {scale:.3g}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library (h + y + bias, "
            f"F.layer_norm) {library_ms:.4f} ms bound {results[key]['bound_ms']:.4f} ms")


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
    wide = _decode_at_width(results, da, torch.Generator(device=DEVICE).manual_seed(3))
    print(f"phase 2 decode attention at B={WIDE_BATCH}: ok; " + "; ".join(wide))
    print("phase 2 decode_attention ptxas: " + "; ".join(_decode_attention_ptxas()))
    # the batch-invariant kernels at the decode's row counts, bf16, and f32 at
    # the kernels line's M = 64 (their own generator, as above)
    inv, gen_inv = [], torch.Generator(device=DEVICE).manual_seed(2)
    for M in INVARIANT_ROWS:
        for case in _matmul_cases(M):
            inv.append(_matmul_vs_plain(results, torch.bfloat16, M, gen_inv, case))
        inv.append(_cumsum_vs_plain(results, torch.bfloat16, M, 10, gen_inv))
        inv.append(_layer_norm_vs_plain(results, torch.bfloat16, M, gen_inv))
    for case in PREFILL_CASES:
        inv.append(_matmul_vs_plain(results, torch.bfloat16, PREFILL_ROWS, gen_inv, case))
    for case in ("mlp_fc", "lm_head"):  # f32 on CUDA cores, both weight layouts
        inv.append(_matmul_vs_plain(results, torch.float32, 64, gen_inv, case))
    # the tensor-parallel modes at the row-parallel shards of tp = 2 (their
    # own generator: the cases above keep their inputs)
    gen_tp = torch.Generator(device=DEVICE).manual_seed(4)
    for M in INVARIANT_ROWS:
        for case in TP_SHARDS:
            for mode in TP_MODES:
                inv.append(_matmul_tp_vs_plain(results, torch.bfloat16, M, gen_tp, case,
                                               mode))
    for case in TP_SHARDS:  # f32: checked, not timed
        for mode in TP_MODES:
            inv.append(_matmul_tp_vs_plain(results, torch.float32, 64, gen_tp, case, mode,
                                           timed=False))
    inv.append(_cumsum_vs_plain(results, torch.float32, 64, 10, gen_inv))
    inv.append(_layer_norm_vs_plain(results, torch.float32, 64, gen_inv))
    inv.append(_cumsum_vs_plain(results, torch.bfloat16, 64, 13317, gen_inv))  # top-p alone
    # the LayerNorm's residual form (its own generator: the cases above keep
    # their inputs)
    gen_ln = torch.Generator(device=DEVICE).manual_seed(3)
    for M in INVARIANT_ROWS:
        inv.append(_add_layer_norm_vs_plain(results, torch.bfloat16, M, gen_ln))
    inv.append(_add_layer_norm_vs_plain(results, torch.float32, 64, gen_ln))
    # the encoder's LayerNorms (D = 512): the topic's B rows and the image and
    # text channels' T x B rows at the smoke's batch
    for M in ENCODER_LN_ROWS:
        inv.append(_layer_norm_vs_plain(results, torch.bfloat16, M, gen_ln, ENCODER_LN_WIDTH))
    inv.append(_layer_norm_vs_plain(results, torch.float32, ENCODER_LN_ROWS[-1], gen_ln,
                                    ENCODER_LN_WIDTH))
    print("phase 2 batch-invariant kernels vs plain: ok; " + "; ".join(inv))
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


_MODELS = {}  # (dtype, seed) -> the repo's model as the decode phases share it


def _full_width_inputs(dtype, seed, mcfg=None, dcfg=None, shared=False):
    """Seeded parameters of ``mcfg`` (default: the repo's model) on the card,
    a random WenLan / CLIP table and a maker of synthetic prompt batches.
    ``shared``: the repo's model built once for each dtype and seed, for the
    phases that only decode with it (3, 12, 13, 25; a train step would
    update it in place)."""
    if shared and mcfg is None and (dtype, seed) in _MODELS:
        return _MODELS[(dtype, seed)]
    made = _make_full_width_inputs(dtype, seed, mcfg, dcfg)
    if shared and mcfg is None:
        _MODELS[(dtype, seed)] = made
    return made


def _make_full_width_inputs(dtype, seed, mcfg=None, dcfg=None):
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
    from mmtg_tpu_torch.ops import cumsum as cs
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import decode_megakernel as mk
    from mmtg_tpu_torch.ops import fused_gru as fg
    from mmtg_tpu_torch.ops import layer_norm as ln
    from mmtg_tpu_torch.ops import matmul as mm
    from mmtg_tpu_torch.ops import train_attention as ta

    counted = {fn.__name__: (fn, "launches") for fn in da.WRAPPERS}
    counted["decode_block_fused"] = (mk.decode_block_fused, "launches")
    counted["fused_gru"] = (fg.fused_gru, "launches")
    counted["matmul"] = (mm.matmul, "launches")
    counted["row_cumsum"] = (cs.row_cumsum, "launches")
    counted["layer_norm"] = (ln.layer_norm_rows, "launches")
    for name in TRAIN_FNS:
        counted[f"{name}_fwd"] = (getattr(ta, name), "fwd_launches")
        counted[f"{name}_bwd"] = (getattr(ta, name), "bwd_launches")
    return counted


def _counts():
    return {name: getattr(obj, attr) for name, (obj, attr) in _counted().items()}


def _reset_counts():
    for obj, attr in _counted().values():
        setattr(obj, attr, 0)


# held around a counted run while phases 19 and 20 run beside phase 22: the
# counts are this process's, and phase 20 launches kernels in it too
COUNTED = threading.Lock()


def _beside(fn, *args):
    """``fn(*args)`` started in a thread of its own (a daemon: the script's
    exit stops its child processes, and with them the thread); returns a
    function that waits for it and gives its result or raises its error."""
    box = {}

    def target():
        try:
            box["result"] = fn(*args)
        except BaseException as e:  # re-raised by the waiting thread
            box["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]

    return result


def _only(launches, expected, what):
    """The launch counts are ``expected`` and every other kernel's is 0 (a
    generation path names the batch-invariant kernels' counts:
    :func:`_invariant_launches`; a train path launches none of them)."""
    want = {k: expected.get(k, 0) for k in launches}
    check(launches == want, f"{what}: launch counts {launches} != {want}")


def _channel_launches(kind="GRU", layers=1, steps=GRU_SHAPE["T"]):
    """(matmul, layer_norm) launches of one experience channel on the
    inference path: a single-layer GRU's input projection (its recurrence is
    the fused GRU kernel); a recurrent stack's input projection and one
    ``h @ w_hh`` a step, a layer; the TRM block's five dense products, its
    scores and ``probs @ v`` and its two LayerNorms."""
    if kind == "TRM":
        return 7, 2
    if kind == "GRU" and layers == 1:
        return 1, 0
    return layers * (1 + steps), 0


def _invariant_launches(L, length, calls=1, dcfg=None, fused=False,
                        channel=("GRU", 1), sampling=True):
    """The batch-invariant kernels' launches in ``calls`` generate calls of
    ``length`` tokens and ``L`` layers (``matmul``: the encoder's products —
    the topic product, the image and text channels' (both of ``channel`` =
    (kind, layers): :func:`_channel_launches`), the two alpha attentions'
    five products each, the beta attention's three — the prefill's projector
    (2), six products a layer and its LM head, then a step's projector (2)
    and LM head and, on the per-layer path (``fused`` False), its four
    products a layer; ``row_cumsum``: the nucleus's prefix sum a sampled,
    not frame-forced, step (none without ``sampling``: a teacher-forced
    call); ``layer_norm``: the encoder's three and its channels', the
    prefill's two a layer and its final one, a step's final one and, per
    layer, its two a layer)."""
    from mmtg_tpu_torch.ops.sampling import frame_forced_token

    frame = 22 if dcfg is None else dcfg.sent_frame_length
    sampled = sum(not frame_forced_token(i, frame)[0] for i in range(length)) \
        if sampling else 0
    ch_mm, ch_ln = _channel_launches(*channel)
    encoder = 1 + 2 * ch_mm + 2 * 5 + 3
    products = encoder + 2 + 6 * L + 1 + length * (3 + (0 if fused else 4 * L))
    norms = 3 + 2 * ch_ln + 2 * L + 1 + length * (1 if fused else 2 * L + 1)
    return {"matmul": calls * products, "row_cumsum": calls * sampled,
            "layer_norm": calls * norms}


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
    import dataclasses

    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0, shared=True)
    steps = mcfg.gpt2.n_layer * LENGTH  # one launch per layer and step
    inv = _invariant_launches(mcfg.gpt2.n_layer, LENGTH, dcfg=dcfg)
    runs = [("b64 int8 cache", 64, GenerateConfig(cache_dtype="int8"),
             {"decode_attention_int8_append": steps, "fused_gru": 2, **inv}),
            ("b8 bf16 cache", 8, GenerateConfig(cache_dtype="model"),
             {"decode_attention_fp_append": steps, "fused_gru": 2, **inv}),
            # the p50 path: one row, the bf16 cache
            ("b1 bf16 cache", 1, GenerateConfig(cache_dtype="model"),
             {"decode_attention_fp_append": steps, "fused_gru": 2, **inv})]
    batches = {b: make_batch(b) for _, b, _, _ in runs}
    for _, b, gcfg, _ in runs:  # warm-up (cuBLAS handles, allocator)
        generate(params, const, mcfg, dcfg, dataclasses.replace(gcfg, length=WARM_LENGTH),
                 batches[b], torch.Generator(device=DEVICE).manual_seed(0))
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


def phase_batch_invariance(out, gpu, paths, tmp):
    """Phase 25: one (request, seed) decoded by generate(..., row_seeds)
    alone and at B = 8, 16, 32, 64 (rows 0, B//2 and B-1 among random neighbours),
    220 tokens, bf16 on phase 3's model, on the service's three decode paths
    (tools/batch_invariance.PATHS): the first step whose token differs, none
    the pass; the op probe of every op the repair touched (a row's bits at
    each M against M = 1); on a mismatch the whole probe's list, then a
    failure. Then tools/parity_check on a synthetic full-size .pth, two
    batches of 4 of the CLI fixtures' val rows: f32 max-abs of each surface
    against the port's plain path on the CPU within PARITY_ATOL, bf16 beside."""
    import torch

    from mmtg_tpu_torch.params import tree_to
    from mmtg_tpu_torch.tools import batch_invariance as bi
    from mmtg_tpu_torch.tools import parity_check

    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.bfloat16, 0, shared=True)
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    sample = bi.random_rows(1, mcfg, dcfg, gen, torch.bfloat16, DEVICE)
    neighbours = [bi.random_rows(max(INVARIANCE_BATCHES), mcfg, dcfg, gen,
                                 torch.bfloat16, DEVICE)]
    t0 = time.perf_counter()
    with COUNTED:
        _reset_counts()  # ---- this path starts here ------------------------------
        res = bi.decode_paths(params, const, mcfg, dcfg, sample, neighbours,
                              INVARIANCE_BATCHES, LENGTH)
        launches = _counts()  # ---- read just after ---------------------------------
    decode_s = time.perf_counter() - t0
    calls = len(INVARIANCE_BATCHES)  # the lone decode, then one a batch size
    inv = _invariant_launches(mcfg.gpt2.n_layer, LENGTH, 2 * calls, dcfg)
    fused_inv = _invariant_launches(mcfg.gpt2.n_layer, LENGTH, calls, dcfg, fused=True)
    inv = {k: v + fused_inv[k] for k, v in inv.items()}
    steps = mcfg.gpt2.n_layer * LENGTH * calls
    _only(launches, {"decode_attention_int8_append": steps,
                     "decode_attention_fp_append": steps,
                     "decode_block_fused": LENGTH * calls, "fused_gru": 2 * 3 * calls,
                     **inv}, "phase 25 decode paths")
    first = {path: r["first_diff"] for path, r in res.items()}
    t0 = time.perf_counter()
    ops = bi.op_probe(params, mcfg, dcfg, INVARIANCE_BATCHES, library=False)
    # the encoder's ops (every channel kind) in f32 too, where any change of
    # summation order shows
    ops_f32 = bi.op_probe(tree_to(params, dtype=torch.float32), mcfg, dcfg,
                          INVARIANCE_BATCHES, torch.float32, library=False,
                          prefix="encoder")
    ops.update({f"{k} (f32)": v for k, v in ops_f32.items()})
    channel_ops = [bi.channel_op(name) for name in bi.CHANNELS]
    check(all(k in ops and f"{k} (f32)" in ops for k in channel_ops),
          f"phase 25: the probe lacks a channel kind: {channel_ops} in {sorted(ops)}")
    bad_ops = {k: v["differs"] for k, v in ops.items() if v["differs"]}
    if any(v is not None for v in first.values()) or bad_ops:
        full = bi.op_probe(params, mcfg, dcfg, INVARIANCE_BATCHES)
        print("phase 25 probe: " + json.dumps(bi.differing(
            {"decode": first, "ops": full})))
    check(all(v is None for v in first.values()),
          f"phase 25: a row's tokens depend on its batch: first differing step {first}")
    check(not bad_ops, f"phase 25: the port's ops differ by M: {bad_ops}")
    probe_s = time.perf_counter() - t0
    # ---- parity_check on a synthetic full-size reference .pth -------------
    t0 = time.perf_counter()
    pth = os.path.join(tmp, "synthetic_reference.pth")
    args = parity_check.build_arg_parser().parse_args([
        "--make-synthetic-ckpt", pth, "--ckpt", pth, "--data", paths["val"],
        "--vocab", paths["vocab"], "--token_emb_path", paths["emb"],
        "--batch_size", "4", "--max_batches", "2", "--atol", str(PARITY_ATOL),
        "--device", DEVICE])
    with COUNTED:
        _reset_counts()
        rep = parity_check.run(args, mcfg, dcfg)
        parity_launches = {k: v for k, v in _counts().items() if v}
    os.remove(pth)
    parity_s = time.perf_counter() - t0
    check(len(rep["float32"]["train"]["per_batch"]) == 2, f"phase 25 parity: {rep}")
    check(rep["ok"] and rep["max_abs_logits_diff"] <= PARITY_ATOL,
          f"phase 25 parity: f32 max-abs {rep['max_abs_logits_diff']} > {PARITY_ATOL}")
    check(parity_launches.get("mha_train_packed_fwd", 0) > 0
          and parity_launches.get("decode_attention_fp_append", 0) > 0,
          f"phase 25 parity: the kernels did not run: {parity_launches}")
    out["batch_invariance"] = dict(
        gpu=gpu, first_diff=first, runs={k: r["runs"] for k, r in res.items()},
        ops=ops, launches=launches, decode_s=decode_s, probe_s=probe_s,
        parity=rep, parity_launches=parity_launches, parity_s=parity_s)
    surf = lambda d: ", ".join(f"{k} {v['max_abs_logits_diff']:.3g}"  # noqa: E731
                               for k, v in d.items())
    print(f"phase 25 batch invariance (full width, bf16, {LENGTH} tokens, B "
          f"{','.join(map(str, INVARIANCE_BATCHES))}, rows 0, B//2 and B-1, on {gpu}): ok; "
          f"first differing step " + ", ".join(f"{k} {'none' if v is None else v}"
                                               for k, v in first.items())
          + f" ({decode_s:.1f} s); op probe of the port's {len(ops)} ops (the encoder's "
          f"also in f32; the channels {', '.join(channel_ops)}): none differs "
          f"({probe_s:.1f} s); launches { {k: v for k, v in launches.items() if v} }")
    print(f"phase 25 parity_check (synthetic full-size .pth, 2 batches of 4, yardstick "
          f"the port's plain path on the CPU in f32, on {gpu}): ok; f32 {surf(rep['float32'])}"
          f" (atol {PARITY_ATOL}); bf16 {surf(rep['bfloat16'])}; {parity_s:.1f} s")
    return launches


def phase_generate_serving(out, gpu):
    """The serving decode paths of decoding.generate at full width, B=64, bf16,
    220 tokens: int4 cache, merged k||v cache, the whole-step kernel, beside
    the int8 per-layer path of the same run; launch counts asserted."""
    import dataclasses

    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0, shared=True)
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
        generate(params, const, mcfg, dcfg, dataclasses.replace(gcfg, length=WARM_LENGTH),
                 batch, torch.Generator(device=DEVICE).manual_seed(0))
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
        _only(got, {**expected, "fused_gru": 2, **_invariant_launches(
            mcfg.gpt2.n_layer, LENGTH, dcfg=dcfg, fused=gcfg.attn_impl == "fused")}, what)
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

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0, shared=True)
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
                     "fused_gru": 6,
                     **_invariant_launches(mcfg.gpt2.n_layer, LENGTH, 3, dcfg)}, "stream")
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
        L = service.params["gpt2"]["h"]["attn_w"].shape[0]
        _only(launches, {"decode_block_fused": 2 * LENGTH, "fused_gru": 4,
                         **_invariant_launches(L, LENGTH, 2, dcfg, fused=True)}, "serve")
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
    """One train step under utils/logging.maybe_profile (the GPU timeline
    alone), attributed by the trace tools' parser and categories
    (tools/trace_train.parse_trace, as phase 24)."""
    import torch

    from mmtg_tpu_torch.tools import trace_train
    from mmtg_tpu_torch.utils.logging import maybe_profile

    d = tempfile.mkdtemp(prefix="mmtg_profile_")
    try:
        with maybe_profile(d, host_ops=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, const, batch, 3)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        r = trace_train.parse_trace(d, 1)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(r["on_gpu"] and bool(r["per_op"]),
          f"{what} profile: torch.profiler recorded no kernel")
    groups = {label: us / 1e3 for label, us in r["cats"].most_common()}
    total = r["total_us"] / 1e3
    out[key] = dict(
        wall_ms=wall_ms, device_ms=total, device_wall_ms=r["wall_us"] / 1e3,
        busy_share=total / wall_ms, groups_ms=groups,
        kernels=[dict(name=n[:120], ms=us / 1e3, calls=r["per_op_count"][n])
                 for n, us in r["per_op"].most_common(25)])
    print(f"{what} profile (one step under torch.profiler): wall "
          f"{wall_ms:.1f} ms, kernel time {total:.1f} ms (busy share "
          f"{total / wall_ms:.3f}); " + "; ".join(
              f"{g} {ms:.1f} ms" for g, ms in groups.items()))
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
    _only(gen_counts, {"decode_attention_int8_append": 2 * LENGTH, "fused_gru": 2,
                       **_invariant_launches(2, LENGTH, dcfg=dcfg)},
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
CHANNEL_ALONE_ROW = 37  # the B=64 row phase 15 also decodes alone
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
    B=64 with row seeds (bf16, int8 cache; no fused_gru launch: it is for GRU
    channels; every channel product and LayerNorm through the batch-invariant
    kernels), one of its rows decoded alone with its seed (the same
    LENGTH tokens: batch invariance), teacher-forced f32 logits through the
    kernels vs the plain versions, and bf16 train steps at B=64 (dropout and
    remat on)."""
    import dataclasses

    import torch

    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate, teacher_forced_decode_logits
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.params import tree_to

    t_phase = time.perf_counter()
    base_mcfg, dcfg = depth_cut(CUT_DEPTH)
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
        batch32 = make_batch(64)
        batch = _to_dtype(batch32, torch.bfloat16)
        seeds = torch.arange(64, dtype=torch.int64, device=DEVICE) * 13 + 5
        key = prng.PRNGKey(1, device=DEVICE)
        # the weights pinned to what B=64 resolves to: 'auto' would give the
        # row alone int8 weights (as the service pins dtypes for its menu)
        gcfg = GenerateConfig(cache_dtype="int8", weight_dtype="model")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(p16, c16, mcfg, dcfg, gcfg, batch, key, row_seeds=seeds)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        before, got = _delta(before, f"{kind} generate",
                             {"decode_attention_int8_append": steps,
                              **_invariant_launches(L, LENGTH, dcfg=dcfg,
                                                    channel=(kind, 1))})
        _check_tokens(toks, mcfg, dcfg, f"{kind} generate")
        # batch invariance: one row alone, with its seed, gives its tokens
        row = CHANNEL_ALONE_ROW
        alone = generate(p16, c16, mcfg, dcfg, gcfg,
                         {k: v[row:row + 1] for k, v in batch.items()}, key,
                         row_seeds=seeds[row:row + 1])
        alone_equal = bool(torch.equal(alone[0], toks[row]))
        check(alone_equal, f"{kind} generate: row {row} decoded alone differs from its row "
              f"at B=64 (first differing token "
              f"{int((alone[0] != toks[row]).nonzero()[0, 0]) if not alone_equal else -1})")
        before = _counts()
        del p16, c16

        small = {k: v[:8] for k, v in batch32.items()}
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
                           {"decode_attention_int8_append": L * (TF_STEPS - 1),
                            **_invariant_launches(L, TF_STEPS - 1, dcfg=dcfg,
                                                  channel=(kind, 1), sampling=False)})
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
                         generate_launches=got, row_alone_equal=alone_equal,
                         teacher_forced_max_abs=tf_err,
                         train_step_ms=r["step_ms"], train_losses=r["losses"],
                         train_launches=r["launches"])
        lines.append(f"{kind}: generate B=64 {gen_s:.3f} s ({64 * LENGTH / gen_s:.1f} "
                     f"tok/s, {steps} int8 appends, 0 fused_gru, {got['matmul']} matmul, "
                     f"{got['layer_norm']} layer_norm), row {CHANNEL_ALONE_ROW} alone = its "
                     f"row at B=64 "
                     f"({LENGTH} tokens), teacher-forced "
                     f"{tf_err:.3g}, train step {r['step_ms']:.1f} ms loss "
                     f"{r['losses'][-1]:.4f}")
        del state, step, params, const
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    out["channels"] = dict(wall_s=wall, **res)
    print(f"phase 15 encoder channels LSTM / RNN / TRM (full width, {L} layers; "
          f"generate bf16 B=64 int8 cache with row seeds, a row alone the same tokens, "
          f"teacher-forced f32 B=8 kernels vs plain <= "
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
        before, got = _delta(before, f"english generate {what}",
                             {**expected, **_invariant_launches(L, LENGTH, dcfg=dcfg)})
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
    _only(_counts(), {"decode_attention_int8_append": 2 * LENGTH, "fused_gru": 2,
                      **_invariant_launches(2, LENGTH, dcfg=cli_dcfg)},
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
                      "fused_gru": 2 * calls,
                      **_invariant_launches(2, LENGTH, calls, dcfg)}, "predict")

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
        with COUNTED:
            torch.cuda.synchronize()
            _reset_counts()  # ---- each run of this path starts here --------------
            yield
            torch.cuda.synchronize()
            seen[label] = _counts()  # ---- read just after it -----------------------

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
                  {kernel: L * LENGTH, "fused_gru": 2,
                   **_invariant_launches(L, LENGTH, dcfg=dcfg)},
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
# Phase 23: the serving and latency tools (mmtg_tpu_torch/tools/)

TOOL_BUCKETS = "8,16,32,64"
SOAK = dict(seconds=12, snapshot_every_s=4, buckets="8,32,64", producers=2,
            overload_depth=128, attn_impl="fused")
SWEEP = dict(batch=64, lengths=(60, 120, 180, 220), runs=3)
SERVING_BUDGET_S = 180  # the phase's share of the script's time limit


def _decode_launches(attn_impl, cache_dtype, length, calls, L):
    """The launch counts of ``calls`` decode calls (service windows or
    generate calls) of ``length`` tokens: the decode step's kernel (one
    launch a layer and step on the per-layer path, one a step fused), the
    encoder's two GRUs a call and the batch-invariant kernels
    (:func:`_invariant_launches`)."""
    if attn_impl == "fused":
        want = {"decode_block_fused": length * calls}
    else:
        kernel = {"int8": "decode_attention_int8_append",
                  "model": "decode_attention_fp_append",
                  "int4": "decode_attention_int4_append"}[cache_dtype]
        want = {kernel: L * length * calls}
    want["fused_gru"] = 2 * calls
    want.update(_invariant_launches(L, length, calls, fused=attn_impl == "fused"))
    return want


def phase_serving_tools(out, gpu):
    """Phase 23: each tool of mmtg_tpu_torch/tools/ through its ``run`` at
    full width in bf16 on the card (one seeded model shared by all): the
    service saturated by 64 closed-loop clients on the per-layer path (int8
    cache) and on the whole-step kernel, solo requests, sequential and
    concurrent streams, two 20 s open-loop Poisson soaks (half and twice the
    saturation capacity), the HTTP front with JSON and npz bodies, the
    fixed-cost sweep and the decode latency matrix against its memory floor.
    Every scenario's launches are counted from 0 and held against the
    windows (or calls) it ran."""
    import contextlib
    import io

    import torch

    from mmtg_tpu_torch.tools import (bench_latency, bench_serve,
                                      bench_serve_http, bench_stream,
                                      fixed_cost_sweep, soak_serve)
    from mmtg_tpu_torch.tools.serve_common import build_model

    t_phase = time.perf_counter()
    mcfg, dcfg = model_configs()
    L = mcfg.gpt2.n_layer
    kind = device_kind()
    t0 = time.perf_counter()
    weights = build_model(device=DEVICE)[:2]
    build_s = time.perf_counter() - t0
    seen, res = {}, {}

    def tool(mod, name, argv):
        """``mod.run`` on the card, its printed lines kept (shown if it fails)."""
        @contextlib.contextmanager
        def observe(label):
            torch.cuda.synchronize()
            _reset_counts()
            yield
            torch.cuda.synchronize()
            seen[f"{name} {label}"] = _counts()

        args = mod.build_arg_parser().parse_args(argv + ["--device", DEVICE])
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
                r = mod.run(args, observe=observe, weights=weights)
        except BaseException:
            print(f"phase 23 {name} failed; its output:\n{buf.getvalue()}")
            raise
        r.update(seconds=time.perf_counter() - t0, argv=argv, output=buf.getvalue())
        res[name] = r
        return r

    def windows_launched(name, r, attn):
        """Each scenario's launches = its windows' (serve_common.scenario)."""
        for label, f in r["service"].items():
            check(f["device"] == kind and f["attn_impl"] == attn[label],
                  f"phase 23 {name} {label}: service {f}")
            _only(seen[f"{name} {label}"], _decode_launches(
                f["attn_impl"], f["cache_dtype"], LENGTH, f["windows"], L),
                f"phase 23 {name} {label} ({f['windows']} windows)")

    # ---- bench_serve: saturation per path, then solo ----------------------
    serve_argv = ["--buckets", TOOL_BUCKETS, "--clients", "64", "--requests",
                  "256", "--cache-dtype", "int8"]
    sk = tool(bench_serve, "bench_serve kernel",
              serve_argv + ["--attn-impl", "kernel", "--solo-runs", "3"])
    windows_launched("bench_serve kernel", sk,
                     {"saturation": "kernel", "solo": "kernel"})
    sf = tool(bench_serve, "bench_serve fused",
              serve_argv + ["--attn-impl", "fused", "--solo-runs", "0"])
    windows_launched("bench_serve fused", sf, {"saturation": "fused"})
    sat = {"kernel": sk["lines"][0]["detail"], "fused": sf["lines"][0]["detail"]}
    cap = {p: d["requests_per_s"] for p, d in sat.items()}  # C, requests/s
    for p, r in (("kernel", sk), ("fused", sf)):
        check(sat[p]["mean_batch"] > 1
              and sat[p]["batches"] == r["service"]["saturation"]["windows"],
              f"phase 23 bench_serve {p}: {sat[p]}")
    solo = sk["lines"][1]
    print(f"phase 23 bench_serve (64 closed-loop clients, 256 requests, buckets "
          f"{TOOL_BUCKETS}, int8 cache, on {gpu}): ok; " + "; ".join(
              f"{p}: {d['requests_per_s']} requests/s, "
              f"{round(256 * LENGTH / d['wall_s'])} tok/s, p50 {d['p50_latency_s']} s, "
              f"p95 {d['p95_latency_s']} s, mean_batch {d['mean_batch']}, fill "
              f"{d['mean_fill']}, {d['batches']} windows "
              f"({r['service']['saturation']['windows_per_s']:.2f}/s), weights "
              f"{r['service']['saturation']['weight_dtype']}"
              for (p, d), r in zip(sat.items(), (sk, sf)))
          + f"; solo (bucket 8, zero window, weights "
          f"{sk['service']['solo']['weight_dtype']}): p50 {solo['value']} s, best "
          f"{solo['detail']['best_s']} s of {solo['detail']['runs']}")

    # ---- bench_stream: sequential, then 16 concurrent streams -------------
    st = tool(bench_stream, "bench_stream", ["--streams", "3"])
    d = st["lines"][0]["detail"]
    check(d["tokens_identical_to_batched"] and st["service"]["streams"]["windows"] == 6,
          f"phase 23 bench_stream: {d}, {st['service']}")
    windows_launched("bench_stream", st, {"streams": "kernel"})
    sc = tool(bench_stream, "bench_stream concurrent",
              ["--concurrent", "16", "--buckets", "8,16", "--rounds", "2"])
    c = sc["lines"][0]["detail"]
    check(c["mean_batch"] > 1, f"phase 23 concurrent streams share no window: {c}")
    windows_launched("bench_stream concurrent", sc, {"concurrent": "kernel"})
    print(f"phase 23 bench_stream (buckets 8, weights {d['gcfg']['weight_dtype']}, cache "
          f"{d['gcfg']['cache_dtype']}, on {gpu}): ok; 3 streams equal their batched "
          f"responses; time to first sentence p50 {d['ttfs_ms_p50']} ms (best "
          f"{d['ttfs_ms_best']}), inter-block p50 {d['inter_block_ms_p50']} ms, stream "
          f"total p50 {d['stream_total_ms_p50']} ms against one-shot "
          f"{d['oneshot_ms_p50']} ms; 16 concurrent streams (buckets 8,16), "
          f"{len(c['rounds'])} rounds: {sc['lines'][0]['value']} tok/s, time to first "
          f"sentence p50 {c['ttfs_ms_p50']} ms, total p50 {c['stream_total_ms_p50']} "
          f"ms, mean_batch {c['mean_batch']}, {c['windows']} windows")

    # ---- soak_serve: open-loop Poisson at 0.5 C and 2 C -------------------
    C = cap[SOAK["attn_impl"]]
    max_bucket = int(SOAK["buckets"].split(",")[-1])

    def soak(name, rate, depth):
        r = tool(soak_serve, name, [
            "--rate", f"{rate:.3f}", "--duration_s", str(SOAK["seconds"]),
            "--snapshot_every_s", str(SOAK["snapshot_every_s"]),
            "--buckets", SOAK["buckets"], "--producers", str(SOAK["producers"]),
            "--max_queue_depth", str(depth), "--cache-dtype", "int8",
            "--attn-impl", SOAK["attn_impl"]])
        windows_launched(name, r, {"soak": SOAK["attn_impl"]})
        return r, r["lines"][-1]

    under, su = soak("soak_serve under", 0.5 * C, 4096)
    check(su["ok"] and su["rejected"] == 0 and su["lost"] == 0,
          f"phase 23 soak at 0.5 C: {su}")
    over, so = soak("soak_serve overload", 2 * C, SOAK["overload_depth"])
    # the queue, plus the window forming and at most two formed windows not
    # yet collected (serve.GenerationService._inflight); a producer may pass
    # the depth check while another's put is under way
    bound = SOAK["overload_depth"] + SOAK["producers"] - 1 + 3 * max_bucket
    check(so["ok"] and so["rejected"] > 0 and so["lost"] == 0
          and so["max_backlog"] <= bound,
          f"phase 23 soak at 2 C: {so} (backlog bound {bound})")

    def intervals(r):
        return ", ".join(f"{ln['interval_p50_s']}/{ln['interval_p99_s']}"
                         for ln in r["lines"][:-1])

    print(f"phase 23 soak_serve ({SOAK['attn_impl']} path, C = {C} requests/s from "
          f"bench_serve, {SOAK['producers']} Poisson producers, {SOAK['seconds']} s, "
          f"buckets {SOAK['buckets']}, on {gpu}): ok; 0.5 C: {su['done']} done, 0 "
          f"rejected, p50 {su['p50_s']} s, p99 {su['p99_s']} s, per-interval p50/p99 "
          f"{intervals(under)} s, max backlog {su['max_backlog']}, mean_batch "
          f"{su['mean_batch']}; 2 C (max_queue_depth {SOAK['overload_depth']}): "
          f"{so['done']} done, {so['rejected']} rejected, 0 lost, p50 {so['p50_s']} s, "
          f"p99 {so['p99_s']} s, per-interval {intervals(over)} s, max backlog "
          f"{so['max_backlog']} (bound {bound}), mean_batch {so['mean_batch']}, "
          f"{so['tokens_per_s']} tok/s")

    # ---- bench_serve_http: JSON and npz bodies ----------------------------
    # the service's whole menu: a response is the same whichever bucket its
    # window was padded to (batch invariance, phase 25), so every response
    # must equal submit()'s for its (sample, seed)
    ht = tool(bench_serve_http, "bench_serve_http",
              ["--clients", "16", "--requests", "64", "--buckets", "8,16,32,64",
               "--cache-dtype", "int8", "--attn-impl", "fused"])
    windows_launched("bench_serve_http", ht, {"json": "fused", "npz": "fused"})
    check(ht["tokens_checked"], "phase 23 http: the responses were not checked")
    for line in ht["lines"]:
        d = line["detail"]
        check(d["requests_ok"] == 64 and d["errors"] == 0, f"phase 23 http: {line}")
    for enc, f in ht["service"].items():
        check(64 / f["windows"] > 1, f"phase 23 http {enc}: no window held two rows")
    print(f"phase 23 bench_serve_http (16 keep-alive clients, 64 requests an encoding, "
          f"buckets 8,16,32,64, fused path, on {gpu}): ok; every response equals submit() "
          "with its seed; " + "; ".join(
              f"{enc}: {line['detail']['requests_per_s']} requests/s, p50 "
              f"{line['detail']['p50_latency_s']} s, p95 {line['detail']['p95_latency_s']}"
              f" s, body {line['detail']['payload_bytes']} B, client encode "
              f"{line['detail']['client_encode_ms_per_req']} ms, mean_batch "
              f"{64 / ht['service'][enc]['windows']:.1f}"
              for enc, line in zip(("json", "npz"), ht["lines"])))

    # ---- fixed_cost_sweep, then bench_latency with its F ------------------
    sw = tool(fixed_cost_sweep, "fixed_cost_sweep", [
        "--batch", str(SWEEP["batch"]), "--lengths", ",".join(map(str, SWEEP["lengths"])),
        "--runs", str(SWEEP["runs"]), "--cache-dtype", "int8"])
    for n in SWEEP["lengths"]:
        _only(seen[f"fixed_cost_sweep L={n}"],
              _decode_launches("kernel", "int8", n, SWEEP["runs"], L),
              f"phase 23 fixed_cost_sweep L={n}")
    fit = sw["lines"][0]
    F = fit["fixed_ms"]
    lat = tool(bench_latency, "bench_latency", [
        "--batches", "1,8,32", "--weight-dtypes", "model,int8", "--runs", "3",
        "--fixed-cost-ms", str(F)])
    detail = lat["lines"][0]["detail"]
    check(detail["fixed_cost_ms"] == F and detail["device"] == kind,
          f"phase 23 bench_latency: {detail}")
    for row, (label, calls) in zip(detail["rows"], lat["calls"].items()):
        check(row["x_of_floor"] >= 1, f"phase 23 bench_latency {label}: the wall is "
              f"under its modeled floor: {row}")
        _only(seen[f"bench_latency {label}"], _decode_launches(
            row["attn_impl"], row["cache_dtype"], LENGTH, calls, L),
            f"phase 23 bench_latency {label}")
    print(f"phase 23 fixed_cost_sweep (B={SWEEP['batch']}, int8 cache, lengths "
          f"{SWEEP['lengths']}, p50 of {SWEEP['runs']}, on {gpu}): ok; walls "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in sw["walls_s"].items())
          + f"; F {F} ms, step {fit['per_step_ms_at_0']} ms at 0, "
          f"{fit['per_step_ms_at_L']} at {SWEEP['lengths'][-1]}, F {fit['fixed_share_pct']}%"
          f" of the wall")
    print(f"phase 23 bench_latency ({LENGTH} tokens, p50 of 3, floor = "
          f"roofline.decode_bytes_model / {detail['hbm_peak_gbps']} GB/s + F, on {gpu}): "
          "ok; " + "; ".join(
              f"b{r['batch']} w {r['weight_dtype']} c {r['cache_dtype']}: {r['p50_ms']} ms "
              f"(floor {r['memory_floor_ms']}, x{r['x_of_floor']})"
              for r in detail["rows"]))

    totals = {}
    for counts in seen.values():
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    for name in ("decode_attention_int8_append", "decode_attention_fp_append",
                 "fused_gru", "decode_block_fused"):
        check(totals[name] > 0, f"phase 23: {name} was not launched")
    wall = time.perf_counter() - t_phase
    out["serving_tools"] = dict(
        gpu=gpu, phase_s=wall, model_build_s=build_s, capacity_requests_per_s=cap,
        fixed_cost_ms=F, launches=seen, tools=res)
    print(f"phase 23 serving tools: ok; {wall:.1f} s (budget {SERVING_BUDGET_S} s; "
          f"model built in {build_s:.1f} s; " + ", ".join(
              f"{name} {r['seconds']:.1f} s" for name, r in res.items())
          + f"), on {gpu}")
    return totals


# ---------------------------------------------------------------------------
# Phase 24: the trace tools (mmtg_tpu_torch/tools/trace_decode.py,
# trace_train.py)

TRACE_RUNS = (  # (label, tool module, its flags, steps the trace holds)
    ("decode B=512 int8 per-layer", "trace_decode", ("--batch", "512"), LENGTH),
    ("decode B=64 int8 fused", "trace_decode",
     ("--batch", "64", "--attn-impl", "fused"), LENGTH),
    ("train B=256", "trace_train", ("--batch", "256", "--steps", "3"), 3),
)
TRACE_TIMEOUT_S = 300  # one tool's process
TRACE_BUDGET_S = 60  # the phase's share of the script's time limit
TRACE_SUM_TOL_MS = 0.1  # categories against the busy total, a step
# the port's kernels as the trace names them (demangled), by family
TRACE_KERNELS = {"decode_attention": r"decode_attention\w*kernel",
                 "fused_gru": r"fused_gru_kernel",
                 "decode_block_fused": r"decode_block_fused_kernel",
                 "mha_fwd_tc_kernel": r"mha_fwd_tc_kernel",
                 "mha_bwd_dq_tc_kernel": r"mha_bwd_dq_tc_kernel",
                 "mha_bwd_dkdv_tc_kernel": r"mha_bwd_dkdv_tc_kernel",
                 "matmul": r"matmul_(?:bf16|f32|small)_kernel",
                 "row_cumsum": r"row_cumsum_(?:short|long)_kernel",
                 "layer_norm": r"layer_norm_kernel"}
# the category row each family's events must fall in (else the family's name)
TRACE_ROW = {"row_cumsum": "reduce", "layer_norm": "layernorm"}


def trace_events(parse: dict) -> dict:
    """Events of each of the port's kernel families in a parsed trace
    (``trace_train.parse_trace``), and a check that every one of them falls
    in a category row that names it."""
    import re

    from mmtg_tpu_torch.tools.trace_train import category

    counts = dict.fromkeys(TRACE_KERNELS, 0)
    for name, n in parse["per_op_count"].items():
        for fam, pat in TRACE_KERNELS.items():
            if re.search(pat, name):
                counts[fam] += n
                label = category(name)
                row = TRACE_ROW.get(fam, "mha_" if fam.startswith("mha_") else fam)
                check(label != "other" and row in label,
                      f"phase 24: {name[:80]} falls in '{label}'")
    return counts


def _trace_expected(label, L, dcfg):
    """The kernel events a trace must hold: the launches reckoned for its
    path (``_decode_launches`` for a decode call, ``_train_launches`` for the
    train steps under the policy ``auto`` resolves to at B=256)."""
    import numpy as np

    want = dict.fromkeys(TRACE_KERNELS, 0)
    if label.startswith("decode"):
        fused = "fused" in label
        d = _decode_launches("fused" if fused else "kernel", "int8", LENGTH, 1, L)
        want["fused_gru"] = d["fused_gru"]
        want.update(_invariant_launches(L, LENGTH, dcfg=dcfg, fused=fused))
        if fused:
            want["decode_block_fused"] = d["decode_block_fused"]
        else:
            want["decode_attention"] = d["decode_attention_int8_append"]
    else:
        t = _train_launches("mha_train_packed", L, 3,
                            {"targets": np.empty((256, dcfg.target_length))}, dcfg)
        want["mha_fwd_tc_kernel"] = t["mha_train_packed_fwd"]
        want["mha_bwd_dq_tc_kernel"] = t["mha_train_packed_bwd"]
        want["mha_bwd_dkdv_tc_kernel"] = t["mha_train_packed_bwd"]
    return want


TRACE_CMD = module_cmd  # the tool's command (a CPU rehearsal points it elsewhere)


def _read_trace(label, tool, steps, d, log, run_s, L, dcfg, gpu, final=False):
    """``trace_train --parse-only --json`` over one tool's trace, checked
    (see :func:`phase_trace_tools`) and printed → ``(run record, events)``.
    Kernel events short of the launches reckoned (the profiler lost records)
    pass unless ``final``: the caller traces once more."""
    import contextlib
    import io

    from mmtg_tpu_torch.tools import trace_train

    js = os.path.join(d, "parse.json")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = trace_train.run(trace_train.build_arg_parser().parse_args(
            ["--parse-only", "--out", d, "--steps", str(steps), "--json", js,
             "--top", "10"]))
    parse_s = time.perf_counter() - t0
    with open(js) as f:
        s = json.load(f)
    check(r["parse"]["on_gpu"], f"phase 24 {label}: the trace has no GPU timeline")
    cats = sum(s["categories_ms"].values())
    check(abs(cats - s["ms_per_step_busy"]) <= TRACE_SUM_TOL_MS,
          f"phase 24 {label}: categories {cats} ms against busy "
          f"{s['ms_per_step_busy']} ms a step")
    check(s["ms_per_step_busy"] <= s["ms_per_step_wall"],
          f"phase 24 {label}: busy {s['ms_per_step_busy']} ms over the wall "
          f"{s['ms_per_step_wall']} ms a step")
    got, want = trace_events(r["parse"]), _trace_expected(label, L, dcfg)
    # the eager elementwise kernels a step (the residual adds the LayerNorm
    # kernel takes in, gelu_new, sampling)
    elementwise = sum(
        n for name, n in r["parse"]["per_op_count"].items()
        if trace_train.category(name, r["parse"]["long_names"].get(name, ""))
        .startswith("elementwise")) / steps
    lost = got != want and all(got[k] <= want[k] for k in want)
    check(got == want or (lost and not final),
          f"phase 24 {label}: kernel events {got} != {want}")
    traced = [ln for ln in log.splitlines() if ln.startswith("traced ")]
    rec = dict(tool=tool, run_s=run_s, parse_s=parse_s, lost_records=lost,
               traced_line=traced[-1] if traced else None, events=got,
               busy_share=s["ms_per_step_busy"] / s["ms_per_step_wall"],
               elementwise_events_per_step=elementwise,
               trace_mb=os.path.getsize(trace_train.newest_trace(d)) / 2 ** 20,
               report=buf.getvalue(), **s)
    top = "; ".join(f"{n[:60]} {ms} ms x{r['parse']['per_op_count'][n]}"
                    for n, ms in s["top_ops_ms"].items())
    print(f"phase 24 {tool} {label} (full width, bf16, on {gpu}): "
          f"{'the profiler lost kernel records, traced again' if lost else 'ok'}; "
          f"{run_s:.1f} s, trace {rec['trace_mb']:.0f} MB parsed in {parse_s:.1f} s; "
          f"a {'token' if tool == 'trace_decode' else 'step'}: busy "
          f"{s['ms_per_step_busy']:.3f} ms, wall {s['ms_per_step_wall']:.3f} ms, busy "
          f"share {rec['busy_share']:.3f}; elementwise events {elementwise:.2f} a "
          f"{'token' if tool == 'trace_decode' else 'step'}; categories: "
          + ", ".join(f"{c} {ms:.3f}" for c, ms in s["categories_ms"].items())
          + f"; kernel events {({k: v for k, v in got.items() if v})}; top 10: " + top)
    return rec, got


def phase_trace_tools(out, gpu, tmp):
    """Phase 24: trace_decode (B=512 per-layer, B=64 fused) and trace_train
    (B=256, 3 steps) run as a user runs them, one process each at full width
    on the card; each trace read back by ``trace_train --parse-only --json``:
    categories summing to the busy total, busy within the wall, and every
    port kernel's events equal to the launches reckoned for the path.

    The three processes start together; the second and third do their
    imports (``--after``, :func:`_ready_to_trace`) and then wait until the
    one before them has exited, so no two tools touch the card at once.
    Each trace is read in a thread while the next tool runs. A trace whose
    kernel events fall short of the launches (the profiler lost records: none
    in excess) is taken once more, after the three, and must then hold them
    all."""
    import torch

    t_phase = time.perf_counter()
    mcfg, dcfg = model_configs()
    L = mcfg.gpt2.n_layer
    torch.cuda.empty_cache()  # the tools' processes share the card
    here = os.path.dirname(os.path.abspath(__file__))

    def trace_dir(label):
        return os.path.join(tmp, "trace_" + label.replace(" ", "_").replace("=", ""))

    def start(i, label, tool, flags, go):
        d = trace_dir(label)
        log = open(os.path.join(tmp, f"trace_log_{i}"), "w+")
        cmd = [sys.executable, *TRACE_CMD(f"mmtg_tpu_torch.tools.{tool}", *flags,
                                          "--out", d, "--device", DEVICE, after=go)]
        return d, log, subprocess.Popen(cmd, cwd=here, stdout=log,
                                        stderr=subprocess.STDOUT, text=True)

    def finish(label, tool, log, proc, t0):
        rc = proc.wait(timeout=TRACE_TIMEOUT_S)
        run_s = time.perf_counter() - t0
        log.seek(0)
        text = log.read()
        log.close()
        if rc != 0:
            print(f"phase 24 {tool} {label} failed:\n{text[-6000:]}")
        check(rc == 0, f"phase 24 {tool} {label}: exit {rc}")
        return text, run_s

    procs = []
    for i, (label, tool, flags, steps) in enumerate(TRACE_RUNS):
        go = os.path.join(tmp, f"trace_go_{i}") if i else None
        procs.append((label, tool, steps, go, *start(i, label, tool, flags, go)))
    runs, events, reading = {}, {}, None

    def read(label, *a, final=False):
        runs[label], events[label] = _read_trace(label, *a, L, dcfg, gpu, final=final)

    for i, (label, tool, steps, go, d, log, proc) in enumerate(procs):
        t0 = time.perf_counter()
        if i:
            open(go, "w").close()  # the tool before it has exited
        text, run_s = finish(label, tool, log, proc, t0)
        if reading is not None:
            reading()
        reading = _beside(read, label, tool, steps, d, text, run_s)
    reading()
    for i, (label, tool, flags, steps) in enumerate(TRACE_RUNS):
        if runs[label]["lost_records"]:
            shutil.rmtree(trace_dir(label), ignore_errors=True)  # the new trace alone
            t0 = time.perf_counter()
            d, log, proc = start(len(TRACE_RUNS) + i, label, tool, flags, None)
            text, run_s = finish(label, tool, log, proc, t0)
            read(label, tool, steps, d, text, run_s, final=True)
    wall = time.perf_counter() - t_phase
    out["trace_tools"] = dict(gpu=gpu, phase_s=wall, runs=runs)
    print(f"phase 24 trace tools: ok; {wall:.1f} s (budget {TRACE_BUDGET_S} s; "
          + ", ".join(f"{k} {v['run_s']:.1f} + {v['parse_s']:.1f} s"
                      for k, v in runs.items()) + f"), on {gpu}")
    return events


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
# the f32 runs (streamed against one-shot, against one device, the tokens
# the step logits are held on): three frames, past TF_STEPS
F32_LENGTH = 66
MESH_JOB_CMD = (os.path.abspath(__file__), "--mesh-job")  # + the spec's path


def _mesh_runs(dp, tp, n_layer):
    """(what, dtype name, GenerateConfig changes, expected launches a rank)
    of one mesh: the meshed 'auto' (full-precision cache) in bf16 at full
    length; at SHORT_LENGTH an explicit int8 cache (DP-only and TP) and the
    whole-step kernel on the DP-only mesh, where it is in scope."""
    runs = [("bf16 auto", "bfloat16", {},
             {"decode_attention_fp_append": n_layer * LENGTH, "fused_gru": 2,
              **_invariant_launches(n_layer, LENGTH)})]
    if (dp, tp) != (2, 2):
        runs.append(("bf16 int8 cache", "bfloat16",
                     dict(cache_dtype="int8", length=SHORT_LENGTH),
                     {"decode_attention_int8_append": n_layer * SHORT_LENGTH,
                      "fused_gru": 2, **_invariant_launches(n_layer, SHORT_LENGTH)}))
    if tp == 1:
        runs.append(("bf16 fused", "bfloat16",
                     dict(cache_dtype="int8", weight_dtype="model", attn_impl="fused",
                          length=SHORT_LENGTH),
                     {"decode_block_fused": SHORT_LENGTH, "fused_gru": 2,
                      **_invariant_launches(n_layer, SHORT_LENGTH, fused=True)}))
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
    each mesh of the job, bf16 and f32 against the single-device engine
    (rank 0), streamed against one-shot, the ordered fold of a row-parallel
    product (models/gpt2.tp_sum) against one device's product and its time
    beside an all-reduce's, the decode kernels, the GRU and the product's
    two tensor-parallel modes at the shard shapes against their plain
    versions; with a serve spec, the windows the meshed service will decode.
    Writes rank<r>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mmtg_tpu_torch import decoding, serve
    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.kernels import _build
    from mmtg_tpu_torch.models import gpt2
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg
    from mmtg_tpu_torch.ops import matmul as mm
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.parallel import mesh as pmesh

    _die_with_parent()
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
            getattr(torch, dname), 0, *depth_cut(CUT_DEPTH))
        inputs[dname] = (params, const, make_batch(MESH_B))
    key = prng.PRNGKey(3, device=DEVICE)
    seeds = torch.arange(MESH_B, dtype=torch.int32, device=DEVICE) * 7 + 1
    ref = {}
    if info.rank == 0:  # the single-device engine on the global batch
        # at the cache the meshed 'auto' resolves to: f32, and bf16 at the
        # length of the 'bf16 auto' runs
        for dname, length in (("float32", F32_LENGTH), ("bfloat16", LENGTH)):
            params, const, batch = inputs[dname]
            ref[dname] = decoding.generate(
                params, const, mcfg, dcfg, GenerateConfig(
                    cache_dtype="model", weight_dtype="auto", length=length),
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
            for what, dname, change, expected in _mesh_runs(dp, tp, CUT_DEPTH):
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
                                       tp_sums_per_step=(gpt2.tp_sum.calls - sums)
                                       / gcfg.length)
                if what == "bf16 auto" and ref:
                    m["bf16_rows_equal_single_device"] = float(
                        (toks == ref["bfloat16"]).all(dim=1).float().mean())
            # f32: the sharded engine, streamed vs one-shot, vs one device
            params, const, batch = inputs["float32"]
            gcfg = GenerateConfig(cache_dtype="auto", weight_dtype="auto",
                                  length=F32_LENGTH)
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
            if ref:
                m["f32_rows_equal_single_device"] = float(
                    (toks == ref["float32"]).all(dim=1).float().mean())
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
            if tp > 1:
                # the ordered fold of each row-parallel product over the
                # model group (this rank's K slice) against one device's
                # product of the whole weight, bit for bit; the fold of the
                # step's attn_proj [B/dp, 768 / tp] @ [768 / tp, 768] timed
                # beside an all-reduce of its [B/dp, 768] output
                gen_tp = torch.Generator(device=DEVICE).manual_seed(190)  # alike on all ranks
                i = dist.get_rank(model_group)
                m["fold_equal_single_device"] = {}
                for dname in ("bfloat16", "float32"):
                    dtype = getattr(torch, dname)
                    for case, (K, N) in TP_SHARDS.items():
                        x = torch.randn(MESH_B // dp, K, generator=gen_tp,
                                        device=DEVICE).to(dtype)
                        w = (torch.randn(K, N, generator=gen_tp, device=DEVICE)
                             * 0.02).to(dtype)
                        k = K // tp
                        folded = gpt2.tp_sum(x[:, i * k:(i + 1) * k].contiguous(),
                                             w[i * k:(i + 1) * k], model_group, mm.matmul)
                        same = bool(torch.equal(folded, mm.matmul(x, w)))
                        m["fold_equal_single_device"][f"{case} {dname}"] = same
                        check(same, f"phase 19 {dp}x{tp}: the fold of {case} ({dname}) "
                              "over the model group differs from one device's product")
                    x = torch.randn(MESH_B // dp, D, generator=gen_tp, device=DEVICE).to(dtype)
                    w = (torch.randn(D, D, generator=gen_tp, device=DEVICE) * 0.02).to(dtype)
                    xs, ws = x[:, i * (D // tp):(i + 1) * (D // tp)].contiguous(), \
                        w[i * (D // tp):(i + 1) * (D // tp)]
                    y = mm.matmul(x, w)
                    for name, fn in (("fold", lambda: gpt2.tp_sum(xs, ws, model_group,
                                                                  mm.matmul)),
                                     ("all_reduce", lambda: dist.all_reduce(
                                         y, group=model_group))):
                        for _ in range(5):
                            fn()
                        torch.cuda.synchronize()
                        dist.barrier()
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        t0 = time.perf_counter()
                        start.record()
                        for _ in range(AR_REPS):
                            fn()
                        end.record()
                        end.synchronize()
                        m[f"{name}_ms_{dname}"] = dict(
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
            if tp > 1:  # the product's two modes at this mesh's rows
                for dtype in (torch.bfloat16, torch.float32):
                    for case in TP_SHARDS:
                        for mode in TP_MODES:
                            lines.append(_matmul_tp_vs_plain(
                                results, dtype, MESH_B // dp, gen, case, mode,
                                timed=dtype == torch.bfloat16))
            m["kernels"] = {"|".join(k): v for k, v in results.items()}
            m["kernel_lines"] = lines
            res["meshes"][f"{dp}x{tp}"] = m
            dist.barrier()
        serve_spec = spec.get("serve")
        if serve_spec:  # the windows the meshed service will decode, same mesh
            mcfg, dcfg = model_configs()  # the service's model: all its layers
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
    """:func:`torchrun_cmd` of ``args`` (a script and its flags, or
    :func:`module_cmd`) with ``nproc`` ranks; raises with the end of the
    output when a rank fails or the time runs out (the launcher and its
    ranks then stopped, as when the script is stopped meanwhile)."""
    proc = subprocess.Popen(torchrun_cmd(nproc, args), cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except BaseException:  # the time ran out, or the script is being stopped
        _stop_torchrun(proc)
        raise
    check(proc.returncode == 0, f"torchrun {' '.join(args[:2])} ... exited "
          f"{proc.returncode}:\n{stdout[-4000:]}\n{stderr[-8000:]}")


SERVE_SEED, SERVE_BUCKETS = 5, "4,8"
# the service's first window: (sample, seed) of three one-shot requests and,
# last, a streamed one
SERVE_WINDOW = ([0, 1, 2, 4], [40, 41, 42, 77])
SERVE_CMD = module_cmd("mmtg_tpu_torch.serve")


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
    cmd = torchrun_cmd(4, [*SERVE_CMD, *_serve_argv(paths, model), "--mesh_data", "2",
                           "--mesh_model", "2", "--port", "0", "--no_warmup"])
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
            "--max_wait_ms", "2000", "--seed", str(SERVE_SEED)]


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
            # the promise: every row the single-device engine's tokens
            for dname in ("f32", "bf16"):
                share = m.get(f"{dname}_rows_equal_single_device")
                check(share == 1.0, f"phase 19 {name}: {dname} rows equal to single-device "
                      f"generate: {share} (want 1.0)")
            fold, ar = m.get("fold_ms_bfloat16"), m.get("all_reduce_ms_bfloat16")
            steps = m["runs"]["bf16 auto"]
            lines.append(
                f"{name} ({m['backend']}): generate_sharded B={MESH_B} {LENGTH} tokens, "
                f"{CUT_DEPTH} layers: "
                f"bf16 {steps['wall_s']:.2f} s, f32 ({F32_LENGTH} tokens) "
                f"{m['runs']['f32 auto']['wall_s']:.2f} s; "
                f"{steps['tp_sums_per_step']:g} ordered folds a step"
                + (f" at {fold['device']:.3f} ms each on the device ({fold['host']:.3f} ms "
                   f"host; an all-reduce of the output {ar['device']:.3f} / {ar['host']:.3f} "
                   f"ms) = {fold['device'] * steps['tp_sums_per_step']:.1f} ms a step; the "
                   f"fold = one device's product bit for bit "
                   f"({', '.join(k for k, v in m['fold_equal_single_device'].items() if v)})"
                   if fold else "")
                + "; launches a rank " + ", ".join(
                    f"{what}: {dict((k, v) for k, v in r['launches'].items() if v)}"
                    for what, r in m["runs"].items() if "launches" in r)
                + f"; TP ranks agree; f32 step logits max-abs "
                f"{max(m['f32_logits_max_abs_ranks']):.3g} (<= {MESH_LOGIT_TOL}); rows equal "
                f"to single-device generate: f32 {m['f32_rows_equal_single_device']:.3f}, bf16 "
                f"{m['bf16_rows_equal_single_device']:.3f}; "
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


def _mesh_train_launches(name, steps, policy, n_layer):
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
    _only(launches, _mesh_train_launches(name, steps, policy, mcfg.gpt2.n_layer), what)
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

    _die_with_parent()
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = pmesh.init_distributed(DEVICE)
    t0 = time.perf_counter()
    _build.load()  # the library phase 1 built; a rank waits if one is building
    res = dict(rank=info.rank, world=info.world_size, backend=info.backend,
               device=str(info.device), load_s=time.perf_counter() - t0, runs={})
    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7,
                                                      *depth_cut(CUT_DEPTH))
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


MESH_CLI_CMD = module_cmd("mmtg_tpu_torch.train")


def _mesh_train_cli(paths, tmp):
    """The train CLI under torchrun at depth 2 (default device: the card):
    an epoch on --mesh_data 2 --zero1, --resume of its save path on
    --mesh_model 2, then the single-device generate CLI on that save path."""
    import dataclasses

    import torch

    from mmtg_tpu_torch import generate as gen_cli

    mcfg, dcfg = depth_cut(CUT_DEPTH)
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
    with COUNTED:  # not inside another phase's counted run
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
          f"{gpu}, {wall:.1f} s; full width, {CUT_DEPTH} layers; global batch "
          f"{MESH_TRAIN_B} bf16, {MESH_TRAIN_F32_B} f32): ok; " + "; ".join(lines)
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
    # no TPU counterpart: the library calls they replace on every generation
    # path, so that a row's tokens do not depend on its batch (phase 25)
    # (matmul at the step's MLP input product; every shape in "shapes")
    ("matmul", "mmtg_tpu_torch/csrc/matmul.cu",
     "none: no TPU kernel; replaces torch.matmul (cuBLAS) for the decode step's "
     "products and LM head, the prefill's and the encoder's "
     "(mmtg_tpu_torch/models/gpt2.py)", "generate", ("mlp_fc", "M64")),
    ("row_cumsum", "mmtg_tpu_torch/csrc/row_cumsum.cu",
     "none: no TPU kernel; replaces torch.cumsum in the nucleus filter "
     "(mmtg_tpu_torch/ops/sampling.py)", "generate", ("M64",)),
    ("layer_norm", "mmtg_tpu_torch/csrc/layer_norm.cu",
     "none: no TPU kernel; replaces the eager LayerNorm (PyTorch reductions) of the "
     "encoder, the prefill and the decode step (mmtg_tpu_torch/models/gpt2.py)",
     "generate", ("M64",)),
]


# the trace families (phase 24) whose events each kernel's launches make
TRACE_FAMILY = {name: () for name, *_ in KERNELS}
TRACE_FAMILY.update(decode_attention_int8_append=("decode_attention",),
                    fused_gru=("fused_gru",), decode_block_fused=("decode_block_fused",),
                    matmul=("matmul",), row_cumsum=("row_cumsum",),
                    layer_norm=("layer_norm",),
                    mha_train_packed=("mha_fwd_tc_kernel", "mha_bwd_dq_tc_kernel",
                                      "mha_bwd_dkdv_tc_kernel"))


# the kernels the sharded path runs (phase 19)
MESH_KERNELS = ("decode_attention_int8_append", "decode_attention_fp_append",
                "fused_gru", "decode_block_fused")


def _write_json(path, out):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == [WITH_PARENT]:  # torchrun, or a CLI rank torchrun started
        return _run_module_with_parent(argv[1:])
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
    ap.add_argument("--serving-only", action="store_true",
                    help="phase 1 (the build), then phase 23 (the serving and "
                         "latency tools) alone: no kernels line")
    ap.add_argument("--trace-only", action="store_true",
                    help="phase 1 (the build), then phase 24 (the trace tools) "
                         "alone: no kernels line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phase 1 (the build), then phase 19 (sharded serving) "
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
    import signal

    def stopped(signum, frame):  # unwinds through every finally: clause
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stopped)
    _prctl(PR_SET_CHILD_SUBREAPER, 1)
    try:
        return _run(args, torch)
    finally:
        _stop_children()


def _run(args, torch) -> int:
    """The phases (see the module docstring); each one's seconds are kept."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "phase_s": {}}

    def timed(number, phase, *a):
        t0 = time.perf_counter()
        r = phase(out, *a)
        out["phase_s"][number] = round(time.perf_counter() - t0, 1)
        return r

    timed(1, phase_build, args.build_serial)
    gpu = gpu_line()
    out["gpu"] = gpu
    if (args.mesh_train_only or args.quality_only or args.serving_only
            or args.trace_only or args.mesh_only):
        tmp = tempfile.mkdtemp(prefix="mmtg_chip_smoke_")
        try:
            if args.mesh_train_only:
                timed(20, phase_mesh_train, gpu, _cli_fixtures(tmp, model_configs()[1]),
                      tmp)
            elif args.mesh_only:
                timed(19, phase_mesh, gpu, _cli_fixtures(tmp, model_configs()[1]), tmp)
            elif args.quality_only:
                timed(22, phase_quality, gpu, tmp)
            elif args.trace_only:
                timed(24, phase_trace_tools, gpu, tmp)
            else:
                timed(23, phase_serving_tools, gpu)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _write_json(args.json, out)
        print(f"chip_smoke: seconds a phase {out['phase_s']}")
        print(f"gpu: {gpu}")
        return 0
    results = timed(2, phase_kernels)
    if args.kernels_only:
        _write_json(args.json, out)
        print(f"gpu: {gpu}")
        return 0
    # each main path's run, the counts set to 0 before it and read after it
    launches = {"generate": timed(3, phase_generate, gpu)}
    timed(4, phase_teacher_forced)
    launches["oracle"] = timed(11, phase_oracle)
    launches["generate_serving"] = timed(12, phase_generate_serving, gpu)
    launches["stream"] = timed(13, phase_stream, gpu)
    mcfg, dcfg = model_configs()
    tmp = tempfile.mkdtemp(prefix="mmtg_chip_smoke_")
    try:
        paths = _cli_fixtures(tmp, dcfg)
        model = _reference_checkpoint(tmp)
        timed(5, phase_cli, paths, tmp, model)
        launches["serve"] = timed(14, phase_serve, gpu, paths, model)
        os.remove(model)
        launches["serving_tools"] = timed(23, phase_serving_tools, gpu)
        launches["trace_tools"] = timed(24, phase_trace_tools, gpu, tmp)
        launches["train"] = timed(6, phase_train, gpu, args.profile)
        timed(7, phase_train_cli, paths, tmp)
        launches["train_packed"] = timed(8, phase_train_packed, gpu, args.profile)
        launches["train_head_major"] = timed(9, phase_train_head_major, gpu)
        launches["remat"] = timed(21, phase_remat, gpu)
        timed(10, phase_packed_cli, paths, tmp)
        timed(15, phase_channels, gpu)
        timed(16, phase_forward_infer, gpu)
        timed(17, phase_english, gpu, tmp)
        timed(18, phase_predict, gpu, paths, tmp)
        # phases 19 and 20 (torchrun jobs: processes that mostly start up
        # and wait on gloo) run beside each other and phases 22 and 25,
        # which have no speed metric; their walls are taken side by side
        mesh = _beside(timed, 19, phase_mesh, gpu, paths, tmp)
        mesh_train = _beside(timed, 20, phase_mesh_train, gpu, paths, tmp)
        launches["quality"] = timed(22, phase_quality, gpu, tmp)
        launches["batch_invariance"] = timed(25, phase_batch_invariance, gpu, paths, tmp)
        launches["mesh"] = mesh()
        launches["mesh_train"] = mesh_train()
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
            if name == "matmul":
                # every main-path shape of phase 2, bf16
                extra = dict(shapes={
                    f"{k[2]} {k[3]}": {x: v[x] for x in ("ms", "library_ms", "bound_ms",
                                                         "max_abs_err")}
                    for k, v in results.items() if isinstance(k, tuple)
                    and k[:2] == ("matmul", "bfloat16")})
            if name == "layer_norm":
                # both forms at every row count and width of phase 2
                extra = dict(shapes={
                    " ".join(k): {x: v[x] for x in ("ms", "plain_ms", "library_ms",
                                                    "bound_ms", "max_abs_err")}
                    for k, v in results.items() if isinstance(k, tuple)
                    and k[0] in ("layer_norm", "add_layer_norm")})
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
        # the kernel events of each trace of the trace tools (phase 24)
        traced = {label: {k: v for k, v in ev.items() if v and k in TRACE_FAMILY[name]}
                  for label, ev in launches["trace_tools"].items()}
        traced = {label: ev for label, ev in traced.items() if ev}
        if traced:
            extra["trace_tools_events"] = traced
        # every scenario of the serving and latency tools (phase 23)
        if launches["serving_tools"].get(name):
            extra["serving_tools_launches"] = launches["serving_tools"][name]
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
    print(f"chip_smoke: 25 phases in {out['total_s']:.1f} s; seconds a phase "
          f"{out['phase_s']}")
    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
