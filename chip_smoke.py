#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mmtg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for
the numbers in PERF.md):

    python3 chip_smoke.py [--json results.json] [--profile] [--build-serial]

Phases, each printing one line (any failure raises and exits non-zero):
  1. build the CUDA kernels from mmtg_tpu_torch/csrc/ (nvcc, sm_90a) and
     print the build time and the card's name and power limit;
  2. every kernel against its plain PyTorch version on the card, at its
     main path's shapes: the decode kernels (caches and scales bit-exact,
     ctx / GRU output within the stated tolerance) and the train-attention
     pair mha_train_packed forward + backward (ctx, dqkv, dqb at rate 0 and
     rate 0.1 with the same dropout hash, f32 and bf16, B=8 and B=64). Each
     is timed (CUDA events, median of single calls queued behind a sleep
     kernel so host overhead is excluded) beside its plain version and one
     PyTorch library call used nowhere in the port, and its bound (the
     larger of bytes / 3.35 TB/s and operations / peak) is computed;
  3. the generation path, decoding.generate, at the full model width
     (12-layer 768-d GPT-2, vocab 13317, 2048-d WenLan, random seeded
     weights) in bf16: B=64 with the int8 cache, then B=8 with the bf16
     cache; the kernel launch counters prove the kernels ran;
  4. teacher-forced logits through the kernels vs through the plain
     versions, full width, f32;
  5. the generate CLI on a synthetic .pth checkpoint;
  6. the train path, train.make_train_step, at full width: bf16 compute /
     f32 masters, B=64, dropout on, remat on, 1 warm-up + 5 timed steps on
     one repeated batch (loss finite and falling, launch counts asserted),
     then B=8 in f32 without dropout: loss and every gradient leaf through
     the kernels vs through the plain attention;
  7. the train CLI (default device: the card) on synthetic records, depth
     cut to 2 layers: an epoch, a checkpoint, a resumed second epoch.
It then prints the kernels' JSON line and, last, the device JSON line.
--profile adds a torch.profiler kernel-time split of one B=64 train step;
--build-serial also times one nvcc process over all sources beside the
parallel build. Without a CUDA device it exits non-zero and prints no result.
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
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (attention, GRU)
LENGTH = 220
DEVICE = "cuda"
# published H100 SXM peaks the bounds are reckoned against
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TRAIN_T, TRAIN_HD = 256, 64  # 15 + 221 = 236 tokens padded to 256
TRAIN_BATCHES = (8, 64)  # the kernel-vs-plain check; the train step runs 64
# mha_train_packed vs its plain version: (ctx, dqkv, dqb). ctx and dqkv are
# max-abs on values of order 1: f32 differs by summation order only, bf16 by
# one rounding of the working type. dqb sums B*T rows (its entries reach the
# hundreds), in another order and by atomic adds, so it is checked relative
# to its largest entry.
TRAIN_TOL = {"float32": (1e-5, 1e-5, 1e-4), "bfloat16": (2e-2, 4e-2, 2e-2)}


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


def _attention_case(dtype, int8, gen):
    import torch

    dev = DEVICE
    q, k_new, v_new = (torch.randn(B_ATT, D, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
    mask = torch.randint(0, 2, (B_ATT, T_CAP), generator=gen, device=dev,
                         dtype=torch.int32)
    mask[:, 0] = 1
    if int8:
        caches = [torch.randint(-127, 128, (L, B_ATT, T_CAP, D), generator=gen,
                                device=dev, dtype=torch.int8) for _ in range(2)]
        caches += [torch.rand(L, B_ATT, T_CAP, generator=gen, device=dev) * 0.02
                   + 0.005 for _ in range(2)]
    else:
        caches = [torch.randn(L, B_ATT, T_CAP, D, generator=gen, device=dev)
                  .to(dtype) for _ in range(2)]
    return q, k_new, v_new, mask, caches


def phase_kernels(out):
    import torch

    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {}
    lines = []
    for name, int8 in (("decode_attention_int8_append", True),
                       ("decode_attention_fp_append", False)):
        kernel = da.decode_attention_int8_append if int8 else da.decode_attention_fp_append
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, k_new, v_new, mask, base = _attention_case(dtype, int8, gen)
            err = 0.0
            for pos in POSITIONS:
                layer = pos % L
                kc = [c.clone() for c in base]
                pc = [c.clone() for c in base]
                ctx_k = kernel(q, k_new, v_new, *kc, mask, pos, layer, n_head=H)
                ctx_p = da.decode_attention_append_plain(
                    q, k_new, v_new, pc[0], pc[1], mask, pos, layer, H,
                    *(pc[2:] if int8 else ()))
                torch.cuda.synchronize()
                for a, b, what in zip(kc, pc, ("k", "v", "k_scale", "v_scale")):
                    check(torch.equal(a, b), f"{name} {dname} pos {pos}: "
                          f"{what} cache differs from the plain version")
                e = (ctx_k.float() - ctx_p.float()).abs().max().item()
                check(e <= TOL[dname][0], f"{name} {dname} pos {pos}: ctx "
                      f"max-abs {e:.3g} > {TOL[dname][0]}")
                err = max(err, e)
                del kc, pc
            caches = [c.clone() for c in base]

            def run_kernel():
                return kernel(q, k_new, v_new, *caches, mask, TIMED_POSITION,
                              run_kernel.layer, n_head=H)

            def run_plain():
                return da.decode_attention_append_plain(
                    q, k_new, v_new, caches[0], caches[1], mask,
                    TIMED_POSITION, run_kernel.layer, H,
                    *(caches[2:] if int8 else ()))

            def rotate(r):  # a different layer per call: the cache is cold
                run_kernel.layer = r % L

            run_kernel.layer = 0
            ms = device_ms(run_kernel, between=rotate)
            plain_ms = device_ms(run_plain, between=rotate)
            library_ms = None
            if not int8:
                # the library yardstick: write the row, then one SDPA call
                # over the live prefix (no PyTorch call reads an int8 cache)
                W = TIMED_POSITION + 1
                slot = torch.tensor([TIMED_POSITION], device=DEVICE)
                live = (mask[:, :W] != 0)[:, None, None, :]

                def run_library():
                    kc, vc = caches[0][run_kernel.layer], caches[1][run_kernel.layer]
                    kc.index_copy_(1, slot, k_new[:, None])
                    vc.index_copy_(1, slot, v_new[:, None])
                    heads = lambda t: t[:, :W].view(B_ATT, W, H, D // H).transpose(1, 2)  # noqa: E731
                    return torch.nn.functional.scaled_dot_product_attention(
                        q.view(B_ATT, H, 1, D // H), heads(kc), heads(vc),
                        attn_mask=live)

                library_ms = device_ms(run_library, between=rotate)
            # the bound counts what this mask needs: live slots only
            n_live = int((mask[:, :TIMED_POSITION + 1] != 0).sum())
            e, c = q.element_size(), caches[0].element_size()
            nbytes = (3 * B_ATT * D * e + 2 * n_live * D * c
                      + 4 * B_ATT * (TIMED_POSITION + 1)
                      + 2 * B_ATT * D * c + B_ATT * D * e
                      + (2 * 4 * (n_live + B_ATT) if int8 else 0))
            results[(name, dname)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(nbytes, 4.0 * n_live * D, dname))
            lines.append(f"{name}[{dname}] err {err:.3g} kernel {ms:.4f} ms "
                         f"plain {plain_ms:.4f} ms library "
                         f"{'none' if library_ms is None else format(library_ms, '.4f') + ' ms'}"
                         f" bound {results[(name, dname)]['bound_ms']:.4f} ms")
            del base, caches
            torch.cuda.empty_cache()

    s = GRU_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x = torch.randn(s["T"], s["B"], s["I"], generator=gen, device=DEVICE).to(dtype)
        w_ih = (torch.randn(s["I"], 3 * s["H"], generator=gen, device=DEVICE)
                * (2.0 / (3 * s["H"] + s["I"])) ** 0.5).to(dtype)
        w_hh = torch.linalg.qr(torch.randn(3 * s["H"], s["H"], generator=gen,
                                           device=DEVICE))[0].T.contiguous().to(dtype)
        b_ih, b_hh = ((torch.rand(3 * s["H"], generator=gen, device=DEVICE) * 2 - 1)
                      .mul(s["H"] ** -0.5).to(dtype) for _ in range(2))
        args = (x, w_ih, w_hh, b_ih, b_hh)
        y_k = fg.fused_gru(*args)
        y_p = fg.fused_gru_plain(*args)
        torch.cuda.synchronize()
        check(y_k.shape == y_p.shape and y_k.dtype == dtype, "fused_gru shape/dtype")
        e = (y_k.float() - y_p.float()).abs().max().item()
        check(e <= TOL[dname][1], f"fused_gru {dname}: max-abs {e:.3g} > "
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
        results[("fused_gru", dname)] = dict(
            max_abs_err=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(n_elems * x.element_size(), ops, dname))
        lines.append(f"fused_gru[{dname}] err {e:.3g} kernel {ms:.4f} ms "
                     f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                     f"{results[('fused_gru', dname)]['bound_ms']:.4f} ms")
    print("phase 2 kernels vs plain: ok; " + "; ".join(lines))
    lines = phase_train_attention(results, gen)
    print("phase 2 mha_train_packed vs plain: ok; " + "; ".join(lines))
    out["kernels_vs_plain"] = {
        f"{k[0]}[{','.join(str(x) for x in k[1:])}]": v for k, v in results.items()}
    return results


def _sdpa_mask(bias, T):
    """The kernel's causal + key-padding mask as SDPA's boolean mask."""
    import torch

    causal = torch.ones(T, T, dtype=torch.bool, device=bias.device).tril()
    return causal[None, None] & (bias == 0)[:, None, None, :]


def phase_train_attention(results, gen):
    """mha_train_packed forward + backward vs mha_train_packed_plain at the
    train path's layer shape (T=256, H=12, hd=64), with a key-padding tail."""
    import torch

    from mmtg_tpu_torch.ops import train_attention as ta

    T, hd = TRAIN_T, TRAIN_HD
    S3 = 3 * H * hd
    scale = hd ** -0.5
    lines = []
    for B in TRAIN_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            qkv = torch.randn(B, T, S3, generator=gen, device=DEVICE).to(dtype)
            qb = (torch.randn(S3, generator=gen, device=DEVICE) * 0.1).to(dtype)
            bias = torch.zeros(B, T, device=DEVICE)
            bias[:, 236:] = ta.NEG_INF  # the pad to 256
            bias[::3, 200:236] = ta.NEG_INF  # short rows
            co = torch.randn(B, T, H * hd, generator=gen, device=DEVICE).to(dtype)
            seed = torch.tensor([20240229], dtype=torch.int32, device=DEVICE)
            errs = {}
            for rate in (0.0, 0.1):
                outs = []
                for fn in (ta.mha_train_packed, ta.mha_train_packed_plain):
                    a = qkv.clone().requires_grad_(True)
                    b = qb.clone().requires_grad_(True)
                    ctx = fn(a, b, bias, seed, H, rate, scale)
                    dqkv, dqb = torch.autograd.grad(ctx, (a, b), co)
                    torch.cuda.synchronize()
                    outs.append((ctx.detach().float(), dqkv.float(), dqb.float()))
                    del a, b, ctx, dqkv, dqb
                for what, got, ref, tol in zip(("ctx", "dqkv", "dqb"), outs[0],
                                               outs[1], TRAIN_TOL[dname]):
                    check(bool(torch.isfinite(got).all()),
                          f"mha_train_packed {dname} B={B} rate {rate}: {what} not finite")
                    e = (got - ref).abs().max().item()
                    if what == "dqb":
                        e /= max(ref.abs().max().item(), 1e-6)  # relative
                    check(e <= tol, f"mha_train_packed {dname} B={B} rate {rate}: "
                          f"{what} max-abs {e:.3g} > {tol}")
                    errs[f"{what}_rate{rate}"] = e
                del outs
                torch.cuda.empty_cache()
            lines.append(f"[{dname} B={B}] " + " ".join(
                f"{k} {v:.3g}" for k, v in errs.items()))

            # timing, at the main path's rate (dropout 0.1)
            rate = 0.1
            e_sz = qkv.element_size()
            pairs = B * H * T * (T + 1) / 2  # causal (i, j) pairs
            # the function's own inputs read once and outputs written once:
            # forward slab, qkv bias, key bias in, ctx out; backward slab, qkv
            # bias, key bias, d(ctx) in, dqkv and dqb out. What the kernels
            # keep between the two (ctx, the row log-sum-exp) is their choice
            # and is not counted.
            fwd_bytes = (B * T * S3 + S3 + B * T * H * hd) * e_sz + 4 * B * T
            bwd_bytes = (2 * B * T * S3 + 2 * S3 + B * T * H * hd) * e_sz + 4 * B * T
            fwd_bound = bound(fwd_bytes, 4.0 * hd * pairs, dname)
            bwd_bound = bound(bwd_bytes, 10.0 * hd * pairs, dname)
            timed = {}
            for label, fn in (("kernel", ta.mha_train_packed),
                              ("plain", ta.mha_train_packed_plain)):
                with torch.no_grad():
                    timed[f"{label}_fwd"] = device_ms(
                        lambda: fn(qkv, qb, bias, seed, H, rate, scale), reps=11, warmup=2)
                a = qkv.clone().requires_grad_(True)
                b = qb.clone().requires_grad_(True)
                ctx = fn(a, b, bias, seed, H, rate, scale)
                timed[f"{label}_bwd"] = device_ms(
                    lambda: torch.autograd.grad(ctx, (a, b), co, retain_graph=True),
                    reps=11, warmup=2)
                del a, b, ctx
                torch.cuda.empty_cache()
            # the library yardstick: one SDPA call on the same q/k/v, mask, rate
            heads = (qkv + qb).view(B, T, 3, H, hd).permute(2, 0, 3, 1, 4)
            q, k, v = (heads[i].detach().contiguous().requires_grad_(True)
                       for i in range(3))
            del heads
            attn_mask = _sdpa_mask(bias, T)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=attn_mask, dropout_p=rate, scale=scale)
            with torch.no_grad():
                timed["library_fwd"] = device_ms(sdpa, reps=11, warmup=2)
            out = sdpa()
            do = co.view(B, T, H, hd).transpose(1, 2)
            timed["library_bwd"] = device_ms(
                lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
                reps=11, warmup=2)
            del q, k, v, out
            torch.cuda.empty_cache()
            results[("mha_train_packed", dname, B)] = dict(
                max_abs_err=max(errs["ctx_rate0.1"], errs["dqkv_rate0.1"]), errs=errs,
                ms=timed["kernel_fwd"] + timed["kernel_bwd"],
                plain_ms=timed["plain_fwd"] + timed["plain_bwd"],
                library_ms=timed["library_fwd"] + timed["library_bwd"],
                bound_ms=fwd_bound["bound_ms"] + bwd_bound["bound_ms"],
                bound_by=bwd_bound["bound_by"], fwd_bound=fwd_bound,
                bwd_bound=bwd_bound, **timed)
            lines.append(f"[{dname} B={B} ms fwd/bwd] " + " ".join(
                f"{w} {timed[w + '_fwd']:.3f}/{timed[w + '_bwd']:.3f}"
                for w in ("kernel", "plain", "library"))
                + f" bound {fwd_bound['bound_ms']:.3f}/{bwd_bound['bound_ms']:.3f}")
            del qkv, co
            torch.cuda.empty_cache()
    return lines


def _full_width_inputs(dtype, seed):
    import torch

    from mmtg_tpu_torch.params import init_params

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


def _counts():
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg
    from mmtg_tpu_torch.ops import train_attention as ta

    return {"decode_attention_int8_append": da.decode_attention_int8_append.launches,
            "decode_attention_fp_append": da.decode_attention_fp_append.launches,
            "fused_gru": fg.fused_gru.launches,
            "mha_train_packed_fwd": ta.mha_train_packed.fwd_launches,
            "mha_train_packed_bwd": ta.mha_train_packed.bwd_launches}


def _reset_counts():
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg
    from mmtg_tpu_torch.ops import train_attention as ta

    da.decode_attention_int8_append.launches = 0
    da.decode_attention_fp_append.launches = 0
    fg.fused_gru.launches = 0
    ta.mha_train_packed.fwd_launches = 0
    ta.mha_train_packed.bwd_launches = 0


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
             {"decode_attention_int8_append": steps,
              "decode_attention_fp_append": 0, "fused_gru": 2,
              "mha_train_packed_fwd": 0, "mha_train_packed_bwd": 0}),
            ("b8 bf16 cache", 8, GenerateConfig(cache_dtype="model"),
             {"decode_attention_int8_append": 0,
              "decode_attention_fp_append": steps, "fused_gru": 2,
              "mha_train_packed_fwd": 0, "mha_train_packed_bwd": 0})]
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
        check(got == expected, f"{what}: launch counts {got} != {expected}")
        _check_tokens(toks, mcfg, dcfg, what)
        tps = b * LENGTH / wall
        out[f"generate_{what.replace(' ', '_')}"] = dict(
            wall_s=wall, tok_per_s=tps, launches=got)
        lines.append(f"{what}: {wall:.3f} s, {tps:.1f} tok/s, launches {got}")
    launches = _counts()  # ---- read just after the main path ---------------
    print(f"phase 3 generate (full width, bf16, {LENGTH} tokens, on {gpu}): ok; "
          + "; ".join(lines))
    return launches


def phase_teacher_forced(out):
    import torch

    from mmtg_tpu_torch.configs import GenerateConfig, SpecialTokens
    from mmtg_tpu_torch.decoding import teacher_forced_decode_logits

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.float32, 2)
    batch = make_batch(8)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    K = 60
    tokens = torch.randint(103, 8000, (8, K), generator=gen, device=DEVICE,
                           dtype=torch.int32)
    sp = SpecialTokens()
    tokens[:, 0] = sp.start_id
    for j in range(K):  # the sentence frame: EOS closes, START opens
        if j % 22 == 21:
            tokens[:, j] = sp.eos_id
        elif j and j % 22 == 0:
            tokens[:, j] = sp.start_id
    errs = {}
    for cache in ("model", "int8"):
        gcfg = GenerateConfig(cache_dtype=cache)
        a = teacher_forced_decode_logits(params, const, mcfg, dcfg, gcfg, batch,
                                         tokens, use_kernels=True)
        b = teacher_forced_decode_logits(params, const, mcfg, dcfg, gcfg, batch,
                                         tokens, use_kernels=False)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a).all()), f"teacher-forced {cache}: non-finite")
        errs[cache] = (a - b).abs().max().item()
    check(errs["model"] <= 1e-3, f"teacher-forced f32 logits, kernels vs plain: "
          f"max-abs {errs['model']:.3g} > 1e-3")
    out["teacher_forced_max_abs"] = errs
    print(f"phase 4 teacher-forced logits (full width, f32, B=8, {K} tokens), "
          f"kernels vs plain: ok; fp cache max-abs {errs['model']:.3g} (<= 1e-3); "
          f"int8 cache max-abs {errs['int8']:.3g} (reported, not bounded)")


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


def phase_train(out, gpu, profile):
    import torch

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import TrainConfig
    from mmtg_tpu_torch.params import tree_leaves, tree_map

    mcfg, dcfg, params, const, _ = _full_width_inputs(torch.float32, 7)
    L = mcfg.gpt2.n_layer
    B, WARM, STEPS = TRAIN_BATCHES[-1], 1, 5
    tcfg = TrainConfig(dtype="bfloat16", remat=True, lr=1e-4, alpha=0.2,
                       attn_impl="auto")
    state, tx = ttrain.create_train_state(7, mcfg, tcfg, 1, 200, params,
                                          device=DEVICE)
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx)
    batch = _train_batch(B, dcfg, 8)
    for _ in range(WARM):  # also the schedule's rate-0 first update
        state, m = step(state, const, batch, 3)
    torch.cuda.synchronize()

    _reset_counts()  # ---- the main path (train) starts here -----------------
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, const, batch, 3)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = _counts()  # ---- read just after the main path ----------------
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(torch.isfinite(torch.tensor(losses))), f"train: loss not finite {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall on a repeated "
          f"batch: {losses}")
    check(launches["mha_train_packed_fwd"] == 2 * L * STEPS
          and launches["mha_train_packed_bwd"] == L * STEPS,
          f"train: launch counts {launches} != fwd {2 * L * STEPS} (remat) / "
          f"bwd {L * STEPS}")
    check(all(launches[k] == 0 for k in ("decode_attention_int8_append",
                                         "decode_attention_fp_append", "fused_gru")),
          f"train: a decode kernel ran: {launches}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
          "train: a parameter is not finite")
    step_ms = statistics.median(times) * 1e3
    out["train_b64"] = dict(step_ms=step_ms, samples_per_s=B / (step_ms / 1e3),
                            losses=losses, step_ms_all=[t * 1e3 for t in times],
                            peak_memory_gib=peak_gb, launches=launches)
    print(f"phase 6 train (full width, bf16 compute / f32 masters, B={B}, "
          f"dropout on, remat, {STEPS} steps, on {gpu}): ok; median step "
          f"{step_ms:.1f} ms, {B / (step_ms / 1e3):.1f} samples/s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak {peak_gb:.1f} GiB, "
          f"launches fwd {launches['mha_train_packed_fwd']} bwd "
          f"{launches['mha_train_packed_bwd']}")

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, const, batch, 3)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel events only: an operator's row repeats its kernels' time
        rows = sorted(((e.key, e.self_device_time_total, e.count)
                       for e in prof.key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA
                       and e.self_device_time_total > 0), key=lambda r: -r[1])
        check(bool(rows), "train profile: torch.profiler recorded no kernel")
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
        out["train_profile"] = dict(
            wall_ms=wall_ms, device_ms=total, busy_share=total / wall_ms,
            groups_ms=groups,
            kernels=[dict(name=n[:120], ms=us / 1e3, calls=c) for n, us, c in rows[:25]])
        print(f"train profile (one B={B} step under torch.profiler): wall "
              f"{wall_ms:.1f} ms, kernel time {total:.1f} ms (busy share "
              f"{total / wall_ms:.3f}); " + "; ".join(
                  f"{g} {ms:.1f} ms" for g, ms in sorted(groups.items(),
                                                         key=lambda kv: -kv[1])))
    del state, tx, batch
    torch.cuda.empty_cache()

    # kernel path vs plain path: loss and every gradient leaf, B=8, f32
    batch = _train_batch(8, dcfg, 9)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    got = {}
    for impl in ("kernel", "plain"):
        cfg = TrainConfig(dtype="float32", remat=False, alpha=0.2, attn_impl=impl)
        total, m = ttrain.loss_and_metrics(params, const, mcfg, dcfg, cfg, batch,
                                           3, None, True)
        grads = torch.autograd.grad(total, tree_leaves(params))
        torch.cuda.synchronize()
        got[impl] = (float(total.detach()), grads)
    loss_err = abs(got["kernel"][0] - got["plain"][0])
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(got["kernel"][1], got["plain"][1]))
    grad_max = max(b.abs().max().item() for b in got["plain"][1])
    check(loss_err <= 1e-4, f"train f32: loss kernel vs plain differ by {loss_err:.3g}")
    check(grad_err <= 1e-4, f"train f32: a gradient leaf differs by {grad_err:.3g} > 1e-4")
    out["train_kernel_vs_plain"] = dict(loss_abs_err=loss_err, grad_max_abs_err=grad_err,
                                        grad_max=grad_max, leaves=len(got["plain"][1]))
    print(f"phase 6 train, kernel path vs plain path (full width, f32, B=8, no "
          f"dropout): ok; loss |diff| {loss_err:.3g}, {len(got['plain'][1])} gradient "
          f"leaves max-abs {grad_err:.3g} (<= 1e-4; largest gradient {grad_max:.3g})")
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


def phase_cli(out, paths, tmp):
    import torch

    from mmtg_tpu_torch import generate as cli
    from mmtg_tpu_torch.checkpoint import save_reference_checkpoint
    from mmtg_tpu_torch.params import init_params

    mcfg, dcfg = model_configs()
    model = os.path.join(tmp, "model.pth")
    save_reference_checkpoint(model, init_params(mcfg, seed=5), mcfg)
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
    os.remove(model)
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
    out["train_cli"] = dict(seconds=secs, val_loss=[val1, val2], launches=counts)
    print(f"phase 7 train CLI (default device, 2 layers, 2 epochs with --resume): "
          f"ok; {secs:.1f} s, val loss {val1:.4f} -> {val2:.4f}, checkpoints {second}")


KERNELS = [
    ("decode_attention_int8_append", "mmtg_tpu_torch/csrc/decode_attention.cu",
     "mmtg_tpu/ops/decode_attention.py:169"),
    ("decode_attention_fp_append", "mmtg_tpu_torch/csrc/decode_attention.cu",
     "mmtg_tpu/ops/decode_attention.py:137"),
    ("fused_gru", "mmtg_tpu_torch/csrc/fused_gru.cu",
     "mmtg_tpu/ops/fused_gru.py:60"),
    ("mha_train_packed", "mmtg_tpu_torch/csrc/train_attention.cu",
     "mmtg_tpu/ops/train_attention.py:723"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one train step (torch.profiler)")
    ap.add_argument("--build-serial", action="store_true",
                    help="also time a single-process build of the kernels")
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
    launches = phase_generate(out, gpu)
    phase_teacher_forced(out)
    mcfg, dcfg = model_configs()
    tmp = tempfile.mkdtemp(prefix="mmtg_chip_smoke_")
    try:
        paths = _cli_fixtures(tmp, dcfg)
        phase_cli(out, paths, tmp)
        train_launches = phase_train(out, gpu, args.profile)
        phase_train_cli(out, paths, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, source, replaces in KERNELS:
        if name == "mha_train_packed":
            # forward + backward of one layer at the train path's shape
            r = results[(name, "bfloat16", TRAIN_BATCHES[-1])]
            f32 = results[(name, "float32", TRAIN_BATCHES[-1])]
            n = (train_launches["mha_train_packed_fwd"]
                 + train_launches["mha_train_packed_bwd"])
            extra = dict(
                fwd_launches=train_launches["mha_train_packed_fwd"],
                bwd_launches=train_launches["mha_train_packed_bwd"],
                **{k: r[k] for k in ("kernel_fwd", "kernel_bwd", "plain_fwd",
                                     "plain_bwd", "library_fwd", "library_bwd")},
                fwd_bound_ms=r["fwd_bound"]["bound_ms"],
                bwd_bound_ms=r["bwd_bound"]["bound_ms"])
        else:
            r, f32, n, extra = (results[(name, "bfloat16")],
                                results[(name, "float32")], launches[name], {})
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dtype="bfloat16",
            f32_max_abs_err=f32["max_abs_err"], **extra))
    out["kernels"] = kernels
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(f"gpu: {gpu}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
