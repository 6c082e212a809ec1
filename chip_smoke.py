#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mmtg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for
the numbers in PERF.md):

    python3 chip_smoke.py [--json results.json]

Phases, each printing one line (any failure raises and exits non-zero):
  1. build the CUDA kernels from mmtg_tpu_torch/csrc/ (nvcc, sm_90a) and
     print the build time and the card's name and power limit;
  2. every kernel against its plain PyTorch version on the card, at the
     decode path's shapes: caches and scales bit-exact, ctx / GRU output
     within the stated tolerance, and both timed (CUDA events, median of
     25 single calls queued behind a sleep kernel so host overhead is
     excluded);
  3. the main path, decoding.generate, at the full model width (12-layer
     768-d GPT-2, vocab 13317, 2048-d WenLan, random seeded weights) in
     bf16: B=64 with the int8 cache, then B=8 with the bf16 cache; the
     kernel launch counters prove the kernels ran;
  4. teacher-forced logits through the kernels vs through the plain
     versions, full width, f32;
  5. the generate CLI on a synthetic .pth checkpoint.
It then prints the kernels' JSON line and, last, the device JSON line.
Without a CUDA device it exits non-zero and prints no result.
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


def model_configs():
    """The repo's model: 12-layer / 12-head / 768-d GPT-2, vocab 13317,
    2048-d WenLan inputs, 5 experience steps."""
    from mmtg_tpu.configs import DataConfig, ModelConfig

    return ModelConfig(), DataConfig()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def phase_build(out):
    from mmtg_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
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
            results[(name, dname)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            lines.append(f"{name}[{dname}] err {err:.3g} kernel {ms:.4f} ms "
                         f"plain {plain_ms:.4f} ms")
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
        results[("fused_gru", dname)] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms)
        lines.append(f"fused_gru[{dname}] err {e:.3g} kernel {ms:.4f} ms "
                     f"plain {plain_ms:.4f} ms")
    print("phase 2 kernels vs plain: ok; " + "; ".join(lines))
    out["kernels_vs_plain"] = {f"{k[0]}[{k[1]}]": v for k, v in results.items()}
    return results


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

    return {"decode_attention_int8_append": da.decode_attention_int8_append.launches,
            "decode_attention_fp_append": da.decode_attention_fp_append.launches,
            "fused_gru": fg.fused_gru.launches}


def _reset_counts():
    from mmtg_tpu_torch.ops import decode_attention as da
    from mmtg_tpu_torch.ops import fused_gru as fg

    da.decode_attention_int8_append.launches = 0
    da.decode_attention_fp_append.launches = 0
    fg.fused_gru.launches = 0


def _check_tokens(toks, mcfg, dcfg, what):
    import torch

    from mmtg_tpu.configs import SpecialTokens
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

    from mmtg_tpu.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate

    mcfg, dcfg, params, const, make_batch = _full_width_inputs(torch.bfloat16, 0)
    steps = mcfg.gpt2.n_layer * LENGTH  # one launch per layer and step
    runs = [("b64 int8 cache", 64, GenerateConfig(cache_dtype="int8"),
             {"decode_attention_int8_append": steps,
              "decode_attention_fp_append": 0, "fused_gru": 2}),
            ("b8 bf16 cache", 8, GenerateConfig(cache_dtype="model"),
             {"decode_attention_int8_append": 0,
              "decode_attention_fp_append": steps, "fused_gru": 2})]
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

    from mmtg_tpu.configs import GenerateConfig, SpecialTokens
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


def phase_cli(out):
    import numpy as np
    import torch

    from mmtg_tpu.data import make_synthetic_records
    from mmtg_tpu_torch import generate as cli
    from mmtg_tpu_torch.checkpoint import save_reference_checkpoint
    from mmtg_tpu_torch.params import init_params

    here = os.path.dirname(os.path.abspath(__file__))
    vocab = os.path.join(here, "vocab", "vocab.txt")
    tmp = tempfile.mkdtemp(prefix="mmtg_chip_smoke_")
    try:
        mcfg, dcfg = model_configs()
        model = os.path.join(tmp, "model.pth")
        save_reference_checkpoint(model, init_params(mcfg, seed=5), mcfg)
        rng = np.random.default_rng(0)
        records = make_synthetic_records(2, rng, emb_size=dcfg.wenlan_emb_size)
        for r in records:
            r.pop("rating")
        data = os.path.join(tmp, "test.pkl")
        with open(data, "wb") as f:
            pickle.dump(records, f)
        emb = os.path.join(tmp, "token_id2emb_dict.pkl")
        with open(emb, "wb") as f:
            pickle.dump({i: v for i, v in enumerate(
                rng.standard_normal((13317, dcfg.wenlan_emb_size)).astype(np.float32))}, f)
        samples = os.path.join(tmp, "samples.txt")
        t0 = time.perf_counter()
        cli.main(["--data_path", data, "--model_path", model,
                  "--tokenizer_path", vocab, "--token_emb_path", emb,
                  "--batch_size", "4", "--n_samples", "2", "--save_samples",
                  "--save_samples_path", samples, "--device", DEVICE],
                 mcfg=mcfg, dcfg=dcfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(samples, encoding="utf-8") as f:
            lines = f.read().splitlines()
        check(len(lines) == len(records) * 2,
              f"CLI wrote {len(lines)} lines for {len(records) * 2} samples")
        check(all(ln.strip() for ln in lines), "CLI wrote an empty sample")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["cli"] = dict(seconds=secs, samples=len(lines))
    print(f"phase 5 CLI: ok; {len(lines)} samples in {secs:.1f} s, first: "
          f"{lines[0][:40]!r}")


KERNELS = [
    ("decode_attention_int8_append", "mmtg_tpu_torch/csrc/decode_attention.cu",
     "mmtg_tpu/ops/decode_attention.py:169"),
    ("decode_attention_fp_append", "mmtg_tpu_torch/csrc/decode_attention.cu",
     "mmtg_tpu/ops/decode_attention.py:137"),
    ("fused_gru", "mmtg_tpu_torch/csrc/fused_gru.cu",
     "mmtg_tpu/ops/fused_gru.py:60"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
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
    phase_build(out)
    gpu = gpu_line()
    out["gpu"] = gpu
    results = phase_kernels(out)
    launches = phase_generate(out, gpu)
    phase_teacher_forced(out)
    phase_cli(out)

    kernels = []
    for name, source, replaces in KERNELS:
        r = results[(name, "bfloat16")]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], dtype="bfloat16",
            f32_max_abs_err=results[(name, "float32")]["max_abs_err"]))
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
