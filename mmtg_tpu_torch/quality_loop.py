"""The quality loop on the PyTorch port (:mod:`tools/quality_loop.py` of the
JAX package): the reference's 5-epoch curriculum through the train CLI,
generation from its save path per cache mode and seed through the generate
CLI, then BLEU / distinct-n.

A synthetic corpus (``data.make_synthetic_records``: no lyric corpus or
WenLan table ships with the repo, so the loop certifies the pipeline —
learning happens across the curriculum's stage changes, quantized decodes
track the full-precision one — not lyric quality) is trained with
``--curriculums [1,3]`` (reference ``train.sh:2-6``: stage 1 at twice the
batch, stage 2 from epoch 2, stage 3 from epoch 4) and
``--val_interval_ratio 0.5``; the per-epoch val curve is read from the
trainer's log. Each mode of :data:`MODES` then decodes the same prompts
with each seed. Every dtype is named: ``model`` is the full-precision
decode (cache and weights), so ``cache_mode_vs_fp`` scores each quantized
mode against a real fp decode, read against ``fp_seed_divergence_control``
(fp against fp across seeds: sampled trajectories at temperature 1.1
diverge after one flipped token).

    python -m mmtg_tpu_torch.quality_loop [--variant english] [--pack_ab] \\
        [--device cpu] [--work_dir DIR] [--out_json PATH]

The default device is the CUDA card (without one it raises unless
``--device cpu`` is given). ``run`` / ``run_pack_ab`` take ``mcfg`` /
``dcfg`` (default: the JAX tool's 2-layer / 64-d model) and ``dtype``;
``chip_smoke.py`` phase 22 runs both at the full width in bf16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pickle
import re
import tempfile
import time
from typing import Callable, ContextManager, Dict, List, Optional

import numpy as np

from mmtg_tpu_torch.configs import (
    ChannelConfig,
    DataConfig,
    GPT2Config,
    ModelConfig,
)

LYRICS_POOL = [
    "青山一道同云雨",
    "明月何曾是两乡",
    "海内存知己",
    "天涯若比邻",
    "长风破浪会有时",
    "直挂云帆济沧海",
    "会当凌绝顶",
    "一览众山小",
]

# --variant english: the same loop at English-variant settings (byte-level
# BPE vocab trained on this pool, CLIP-sized embeddings, english_variant()
# dims). BLEU stays char-level (eval.tokenize_lyric), the same for
# hypothesis and reference.
ENGLISH_POOL = [
    "city lights are calling out my name tonight",
    "we dance until the morning sun comes up",
    "every heartbeat echoes down the empty street",
    "hold me closer while the music plays",
    "summer rain keeps falling on my mind",
    "chasing shadows through the neon glow",
    "your voice is like a melody i know",
    "we were young and running with the wind",
]

# The generate CLI's flags of each mode, every dtype explicit (with 'auto'
# a decode batch of 8 resolves to an int8 cache AND int8 weights, which
# would make the fp baseline an int8 decode).
MODES: Dict[str, List[str]] = {
    "model": ["--cache_dtype", "model", "--weight_dtype", "model"],
    "int8": ["--cache_dtype", "int8", "--weight_dtype", "model"],
    "int4": ["--cache_dtype", "int4", "--weight_dtype", "model"],
    # the serving-default candidate: int8 cache + weight-only int8
    "int8_w8": ["--cache_dtype", "int8", "--weight_dtype", "int8"],
    # the JAX package's approximate top-k, which is the exact top-k here
    "topk_approx": ["--cache_dtype", "model", "--weight_dtype", "model",
                    "--topk_impl", "approx"],
}
# 4 test records x 2 samples: one decode batch of 8
GEN_FLAGS = ["--batch_size", "8", "--n_samples", "2"]
N_TEST = 4
VAL_LINE = re.compile(r"End eval of epoch (\d+)\. Val\. Loss: (\S+)")
STEP_LINE = re.compile(r"Epoch: (\d+), Step: \d+/(\d+)")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "vocab", "vocab.txt")

Observe = Callable[[str], ContextManager]


def tiny_configs(vocab_size: int = 13317, variant: str = "chinese"):
    """The JAX tool's CI-sized but fully wired model: 2-layer / 4-head /
    64-d GPT-2 (n_positions 256), 32-wide channels, 64-d embeddings.
    Returns ``(mcfg, dcfg)``."""
    gpt2 = GPT2Config(vocab_size=vocab_size, n_positions=256, n_ctx=250,
                      n_embd=64, n_layer=2, n_head=4)
    if variant == "english":
        from mmtg_tpu_torch.configs import english_variant

        mcfg, dcfg = english_variant(clip_dim=64, gpt2_vocab=vocab_size)
        return dataclasses.replace(
            mcfg,
            topic=dataclasses.replace(mcfg.topic, hidden_dim=32),
            image=dataclasses.replace(mcfg.image, hidden_dim=32),
            text=dataclasses.replace(mcfg.text, hidden_dim=32),
            self_att_hidden_size=32, gpt2=gpt2), dcfg
    return ModelConfig(
        topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32),
        text=ChannelConfig(input_dim=64, hidden_dim=32),
        self_att_hidden_size=32, self_att_heads=4, mm_att_out_dim=64,
        gpt2=gpt2), DataConfig(wenlan_emb_size=64)


def mode_dtypes() -> Dict[str, Dict]:
    """Each mode's generate flags and the cache and weight dtypes they
    resolve to in the generate CLI (``generate.resolve_run_dtypes``)."""
    from mmtg_tpu_torch.generate import build_arg_parser, resolve_run_dtypes

    out = {}
    for mode, extra in MODES.items():
        args = build_arg_parser().parse_args(GEN_FLAGS + extra)
        cache, weights, _ = resolve_run_dtypes(args)
        out[mode] = dict(flags=GEN_FLAGS + extra, cache_dtype=cache,
                         weight_dtype=weights, topk_impl=args.topk_impl)
    return out


def train_flags(paths: Dict[str, str], vocab: str, emb_path: str,
                batch_size: int, epochs: int, log: str, dtype: str,
                curriculums: str = "[1,3]", val_interval_ratio: str = "0.5"
                ) -> List[str]:
    """The JAX tool's train CLI flags (the same in both trainers)."""
    return ["--batch_size", str(batch_size), "--val_batch_size", "16",
            "--epochs", str(epochs), "--lr", "3e-4",
            "--curriculums", curriculums, "--log_interval", "5",
            "--val_interval_ratio", val_interval_ratio,
            "--train_data_path", paths["train"],
            "--val_data_path", paths["val"],
            "--vocab_path", vocab, "--token_emb_path", emb_path,
            "--log_path", log, "--alpha", "0.2", "--dtype", dtype,
            "--mesh_data", "1", "--mesh_model", "1"]


def parse_log(log: str) -> Dict[str, List]:
    """The trainer's log: ``val_curve`` (each epoch's end-of-epoch val loss,
    at the logged 4 decimals) and ``steps_per_epoch`` (from the step lines;
    an epoch that logged no step line is absent)."""
    curve, steps = [], {}
    with open(log, encoding="utf-8") as f:
        for line in f:
            m = VAL_LINE.search(line)
            if m:
                curve.append(float(m.group(2)))
            m = STEP_LINE.search(line)
            if m:
                steps[int(m.group(1))] = int(m.group(2))
    return dict(val_curve=curve,
                steps_per_epoch=[steps[e] for e in sorted(steps)])


def _work_dir(work_dir: Optional[str], name: str) -> str:
    work_dir = work_dir or os.path.join(tempfile.gettempdir(), name)
    os.makedirs(work_dir, exist_ok=True)
    return work_dir


def _write_pickle(path: str, obj) -> str:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


def _train(train_main, argv, mcfg, dcfg, log, observe, label):
    """One train CLI run logging to ``log`` (removed first); returns
    ``(final val loss, parse_log(log), seconds)``."""
    if os.path.exists(log):
        os.remove(log)
    t0 = time.perf_counter()
    try:
        with observe(label):
            final = train_main(argv, mcfg=mcfg, dcfg=dcfg)
    finally:  # later runs in this process do not write into this log
        logger = logging.getLogger("mmtg_tpu_torch")
        for h in list(logger.handlers):
            if (isinstance(h, logging.FileHandler)
                    and h.baseFilename == os.path.abspath(log)):
                logger.removeHandler(h)
                h.close()
    return float(final), parse_log(log), time.perf_counter() - t0


def _resolve(device, mcfg, dcfg):
    """The device (the card unless asked otherwise: raises without one) and
    a check that ``mcfg`` / ``dcfg`` come together."""
    from mmtg_tpu_torch.generate import resolve_device

    device = resolve_device(device)
    if (mcfg is None) != (dcfg is None):
        raise ValueError("pass mcfg and dcfg together")
    return device


def _model_name(mcfg: ModelConfig) -> str:
    g = mcfg.gpt2
    return f"{g.n_layer}L/{g.n_head}H/{g.n_embd}d GPT-2, vocab {g.vocab_size}"


def metrics_for(lines: List[str], ref_lines: List[str]) -> Dict:
    """Corpus BLEU-1/2 of ``lines`` against ``ref_lines`` (each reference
    repeated for its ``len(lines) // len(ref_lines)`` samples) and
    distinct-1/2, char-level."""
    from mmtg_tpu_torch.eval import corpus_bleu, distinct_n, tokenize_lyric

    hyps = [tokenize_lyric(line) for line in lines]
    k = len(lines) // len(ref_lines)
    refs = [[tokenize_lyric(r)] for r in ref_lines for _ in range(k)]
    return {"bleu": corpus_bleu(hyps, refs, max_n=2),
            "distinct1": distinct_n(hyps, 1),
            "distinct2": distinct_n(hyps, 2)}


def _mean_std(vals) -> Dict:
    return {"mean": float(np.mean(vals)), "std": float(np.std(vals)),
            "per_seed": [float(v) for v in vals]}


def run(
    n_train: int = 240,
    n_val: int = 32,
    epochs: int = 5,
    batch_size: int = 16,
    out_json: Optional[str] = None,
    seed: int = 0,
    work_dir: Optional[str] = None,
    gen_seeds: tuple = (7, 8, 9),
    variant: str = "chinese",
    device: Optional[str] = None,
    dtype: str = "float32",
    mcfg: Optional[ModelConfig] = None,
    dcfg: Optional[DataConfig] = None,
    observe: Optional[Observe] = None,
) -> dict:
    """Train → generate → eval (``tools/quality_loop.py:60-295``). Writes
    the report to ``out_json`` (default ``<work_dir>/quality_loop.json``)
    and returns it. ``observe(label)`` is a context manager entered around
    the train run (``"train"``) and each generate call (``"generate MODE
    sSEED"``, the repeat ``"generate model sSEED again"``)."""
    from mmtg_tpu_torch.data import make_synthetic_records
    from mmtg_tpu_torch.generate import main as generate_main
    from mmtg_tpu_torch.train import main as train_main

    device = _resolve(device, mcfg, dcfg)
    if variant == "english" and mcfg is not None:
        raise ValueError("--variant english builds its own model config")
    observe = observe or (lambda label: contextlib.nullcontext())
    work_dir = _work_dir(work_dir, f"mmtg_quality_loop_{variant}")
    rng = np.random.default_rng(seed)
    variant_flags: List[str] = []
    if variant == "english":
        # english_variant() dims at CI scale: a BPE vocab trained on the
        # pool, CLIP-sized (64-d here) embeddings
        from mmtg_tpu_torch.bpe import train_bpe

        tok = train_bpe(ENGLISH_POOL, vocab_size=600)
        vocab = os.path.join(work_dir, "bpe_vocab")
        tok.save(vocab)
        vocab_size, pool = len(tok), ENGLISH_POOL
        variant_flags = ["--variant", "english", "--clip_dim", "64"]
    else:
        vocab, vocab_size, pool = VOCAB, 13317, LYRICS_POOL
    if mcfg is None:
        mcfg, dcfg = tiny_configs(vocab_size, variant)
    dev_flags = ["--device", str(device)]
    emb = dcfg.wenlan_emb_size

    # corpus: ratings spanning 1-5 so every curriculum stage keeps samples
    train_recs = make_synthetic_records(n_train, rng, emb_size=emb, lyrics_pool=pool)
    val_recs = make_synthetic_records(n_val, rng, emb_size=emb, lyrics_pool=pool)
    test_recs = make_synthetic_records(N_TEST, rng, emb_size=emb, lyrics_pool=pool)
    ref_lines = ["，".join(r["lyrics"]) for r in test_recs]
    for r in test_recs:
        r.pop("rating")
    paths = {name: _write_pickle(os.path.join(work_dir, f"{name}.pkl"), recs)
             for name, recs in (("train", train_recs), ("val", val_recs),
                                ("test", test_recs))}
    emb_path = _write_pickle(os.path.join(work_dir, "emb.pkl"), {
        i: rng.standard_normal(emb).astype(np.float32) for i in range(vocab_size)})

    # ---- the 5-epoch curriculum (reference train.sh) ------------------------
    save = os.path.join(work_dir, "ckpt")
    log = os.path.join(work_dir, "train.log")
    final_val, parsed, train_s = _train(
        train_main,
        train_flags(paths, vocab, emb_path, batch_size, epochs, log, dtype)
        + ["--save_model", "--save_path", save] + variant_flags + dev_flags,
        mcfg, dcfg, log, observe, "train")
    val_curve = parsed["val_curve"]
    if len(val_curve) != epochs:
        raise RuntimeError(f"{log}: {len(val_curve)} end-of-epoch val losses "
                           f"for {epochs} epochs")
    learned = val_curve[-1] < val_curve[0]

    # ---- generate from the save path: modes x seeds -------------------------
    seeds = list(gen_seeds)
    outs: Dict[str, Dict[int, List[str]]] = {}
    gen_s: Dict[str, List[float]] = {}

    def generate(mode, s, tag=""):
        out_path = os.path.join(work_dir, f"samples_{mode}_s{s}{tag}.txt")
        t0 = time.perf_counter()
        with observe(f"generate {mode} s{s}" + (" again" if tag else "")):
            generate_main(
                ["--data_path", paths["test"], "--model_path", save,
                 "--tokenizer_path", vocab, "--token_emb_path", emb_path,
                 "--seed", str(s), "--save_samples", "--save_samples_path",
                 out_path] + GEN_FLAGS + MODES[mode] + variant_flags + dev_flags,
                mcfg=mcfg, dcfg=dcfg)
        gen_s.setdefault(mode, []).append(time.perf_counter() - t0)
        with open(out_path, encoding="utf-8") as f:
            return [line.rstrip("\n") for line in f]

    for mode in MODES:
        outs[mode] = {s: generate(mode, s) for s in seeds}
    # the fp decode is reproducible: the same seed gives the same lines
    repeat = generate("model", seeds[0], "_again")

    def corpus_summary(mode):
        per_seed = [metrics_for(outs[mode][s], ref_lines) for s in seeds]
        return {"bleu2": _mean_std([m["bleu"]["bleu2"] for m in per_seed]),
                "distinct2": _mean_std([m["distinct2"] for m in per_seed]),
                f"seed{seeds[0]}_full": per_seed[0]}

    report = {
        "config": {
            "n_train": n_train, "n_val": n_val, "epochs": epochs,
            "batch_size": batch_size, "curriculums": [1, 3],
            "model": _model_name(mcfg), "variant": variant, "dtype": dtype,
            "device": str(device), "gen_seeds": seeds, "modes": mode_dtypes(),
            "data": "synthetic fixtures (data.make_synthetic_records); no "
                    "lyric corpus ships with the repo",
        },
        "val_loss_curve": val_curve,
        "final_val_loss": final_val,
        "learned": bool(learned),
        # corpus-side quality per mode: mean ± std over seeds (the std is
        # the fixture's noise floor for reading cross-mode deltas)
        "gen_vs_corpus": {m: corpus_summary(m) for m in outs},
        # each mode scored against the fp decode of the same prompts and seed
        "cache_mode_vs_fp": {
            m: metrics_for(outs[m][seeds[0]], outs["model"][seeds[0]])
            for m in ("int8", "int4", "int8_w8", "topk_approx")},
        # fp against fp across seeds: the BLEU that trajectory divergence
        # alone gives with identical numerics
        "fp_seed_divergence_control": {
            f"seed{s}_vs_seed{seeds[0]}": metrics_for(
                outs["model"][s], outs["model"][seeds[0]])["bleu"]["bleu2"]
            for s in seeds[1:]},
        "fp_repeat_identical": repeat == outs["model"][seeds[0]],
        "samples": outs,
        "seconds": {"train": train_s, "generate": gen_s},
    }
    _dump(report, out_json or os.path.join(work_dir, "quality_loop.json"))
    return report


def run_pack_ab(
    n_train: int = 240,
    n_val: int = 32,
    epochs: int = 3,
    batch_size: int = 16,
    out_json: Optional[str] = None,
    seed: int = 0,
    work_dir: Optional[str] = None,
    device: Optional[str] = None,
    dtype: str = "float32",
    mcfg: Optional[ModelConfig] = None,
    dcfg: Optional[DataConfig] = None,
    observe: Optional[Observe] = None,
) -> dict:
    """Packing quality check (``tools/quality_loop.py:298-395``): one
    corpus trained twice, on parity rows and with ``--pack_sequences
    --pack_row_len 256``; the (always unpacked) val loss is the yardstick
    of both. ``observe`` wraps each run (``"train parity"``, ``"train
    packed"``). Writes ``out_json`` (default ``<work_dir>/pack_ab.json``)."""
    from mmtg_tpu_torch.data import make_synthetic_records
    from mmtg_tpu_torch.train import main as train_main

    device = _resolve(device, mcfg, dcfg)
    if mcfg is None:
        mcfg, dcfg = tiny_configs()
    observe = observe or (lambda label: contextlib.nullcontext())
    work_dir = _work_dir(work_dir, "mmtg_quality_pack")
    rng = np.random.default_rng(seed)
    emb = dcfg.wenlan_emb_size
    paths = {name: _write_pickle(
        os.path.join(work_dir, f"{name}.pkl"),
        make_synthetic_records(n, rng, emb_size=emb, lyrics_pool=LYRICS_POOL))
        for name, n in (("train", n_train), ("val", n_val))}
    emb_path = _write_pickle(os.path.join(work_dir, "emb.pkl"), {
        i: rng.standard_normal(emb).astype(np.float32) for i in range(13317)})

    runs = {}
    for tag, extra in (("parity", []),
                       ("packed", ["--pack_sequences", "--pack_row_len", "256"])):
        log = os.path.join(work_dir, f"train_{tag}.log")
        final, parsed, secs = _train(
            train_main,
            train_flags(paths, VOCAB, emb_path, batch_size, epochs, log, dtype,
                        curriculums="[0,0]", val_interval_ratio="1.0")
            + extra + ["--device", str(device)],
            mcfg, dcfg, log, observe, f"train {tag}")
        runs[tag] = {"final_val": final, "val_curve": parsed["val_curve"],
                     "steps_per_epoch": parsed["steps_per_epoch"], "seconds": secs}
    report = {
        "config": {"n_train": n_train, "epochs": epochs, "batch_size": batch_size,
                   "model": _model_name(mcfg), "dtype": dtype,
                   "device": str(device),
                   "note": "synthetic fixtures; val loss is the PARITY objective "
                           "for both runs (eval is never packed), so the curves "
                           "are comparable"},
        **runs,
        "both_learned": all(r["val_curve"][-1] < r["val_curve"][0]
                            for r in runs.values()),
    }
    _dump(report, out_json or os.path.join(work_dir, "pack_ab.json"))
    return report


def _dump(report: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, ensure_ascii=False)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="chinese", choices=["chinese", "english"])
    ap.add_argument("--pack_ab", action="store_true",
                    help="run the parity-vs-packed training A/B instead of the "
                         "full quality loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass 'cpu' to run "
                         "without a GPU)")
    ap.add_argument("--work_dir", default=None,
                    help="corpus, checkpoints, logs and samples (default: a "
                         "directory under the system's temporary directory)")
    ap.add_argument("--out_json", default=None,
                    help="the report (default: in --work_dir)")
    a = ap.parse_args(argv)
    if a.pack_ab:
        report = run_pack_ab(device=a.device, work_dir=a.work_dir,
                             out_json=a.out_json)
        print(json.dumps({k: report[k] for k in ("parity", "packed", "both_learned")},
                         indent=2))
        return 0
    report = run(variant=a.variant, device=a.device, work_dir=a.work_dir,
                 out_json=a.out_json)
    print(json.dumps({k: v for k, v in report.items() if k != "samples"},
                     indent=2, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
