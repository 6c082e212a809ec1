"""Automatic quality metrics for generated lyrics (:mod:`mmtg_tpu.eval`; pure
Python, the port's own copy).

The MMTG paper reports BLEU and Distinct-n alongside human ratings
(arXiv 2209.02427 §5; the reference repo ships no evaluation code at all —
SURVEY.md §4). This module provides the standard automatic metrics so a
train→generate→evaluate loop is closed inside the framework:

  * corpus BLEU-1..4 (uniform weights, method-1 smoothing) against one or
    more references per hypothesis;
  * Distinct-1/2 (ratio of unique n-grams across the corpus — the
    diversity metric lyric generation papers report);
  * per-sentence framing stats (sentences per lyric, mean length).

Pure Python on tokenized character sequences — for Chinese lyrics the
conventional unit is the character, matching the paper's setup.

CLI: ``python -m mmtg_tpu_torch.eval --hyp res/test.txt --ref refs.txt``
(one lyric per line, sentences joined with '，' as generate.py writes).
"""

from __future__ import annotations

import argparse
import json
import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    hypotheses: List[Sequence[str]],
    references: List[List[Sequence[str]]],
    max_n: int = 4,
    epsilon: float = 0.1,
) -> Dict[str, float]:
    """Corpus-level BLEU-1..max_n with NLTK method-1 smoothing.

    Matches ``nltk.translate.bleu_score.corpus_bleu(...,
    smoothing_function=SmoothingFunction(epsilon=0.1).method1)``:
    numerators/denominators aggregate over the corpus, and a zero-match
    aggregated numerator is replaced by ``epsilon`` — so numbers are
    directly comparable with the paper's reported BLEU."""
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses/references length mismatch")
    results = {}
    for n in range(1, max_n + 1):
        match, total = 0, 0
        for hyp, refs in zip(hypotheses, references):
            hyp_ng = _ngrams(hyp, n)
            best = Counter()
            for ref in refs:
                ref_ng = _ngrams(ref, n)
                for g, c in ref_ng.items():
                    best[g] = max(best[g], c)
            match += sum(min(c, best[g]) for g, c in hyp_ng.items())
            # nltk modified_precision clamps the denominator to 1 PER
            # HYPOTHESIS (Fraction(num, max(1, den))) — a hypothesis
            # shorter than n still contributes 1 to the corpus
            # denominator, so such corpora yield p_n = eps/len, not 0.
            total += max(sum(hyp_ng.values()), 1)
        # NLTK method-1: only zero numerators get the epsilon count
        smoothed = match if match > 0 else epsilon
        results[f"p{n}"] = smoothed / max(total, 1)
        if n == 1:
            unigram_match = match
    # brevity penalty
    hyp_len = sum(len(h) for h in hypotheses)
    ref_len = sum(
        min((len(r) for r in refs), key=lambda L: (abs(L - len(h)), L))
        for h, refs in zip(hypotheses, references)
    )
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    for n in range(1, max_n + 1):
        ps = [results[f"p{k}"] for k in range(1, n + 1)]
        if unigram_match == 0:
            # nltk returns 0 outright when no unigram matches at all
            geo = 0.0
        elif min(ps) > 0:
            geo = math.exp(sum(math.log(p) for p in ps) / n)
        else:
            geo = 0.0
        results[f"bleu{n}"] = bp * geo
    results["bp"] = bp
    return results


def distinct_n(corpus: Iterable[Sequence[str]], n: int) -> float:
    """Unique n-grams / total n-grams over the whole corpus."""
    seen, total = set(), 0
    for tokens in corpus:
        for i in range(len(tokens) - n + 1):
            seen.add(tuple(tokens[i : i + n]))
            total += 1
    return len(seen) / max(total, 1)


def tokenize_lyric(line: str) -> List[str]:
    """Character-level tokens, sentence separator kept out."""
    return [ch for ch in line.strip() if ch and ch != "，"]


def lyric_stats(lines: List[str]) -> Dict[str, float]:
    sents = [line.strip().split("，") if line.strip() else [] for line in lines]
    n_sents = [len([s for s in ss if s]) for ss in sents]
    lens = [len(s) for ss in sents for s in ss if s]
    return {
        "lyrics": len(lines),
        "sentences_per_lyric": sum(n_sents) / max(len(lines), 1),
        "mean_sentence_len": sum(lens) / max(len(lens), 1),
    }


def evaluate_files(hyp_path: str, ref_path: str | None = None) -> Dict:
    with open(hyp_path, encoding="utf-8") as f:
        hyp_lines = [l.rstrip("\n") for l in f if l.strip()]
    hyps = [tokenize_lyric(l) for l in hyp_lines]
    out: Dict = {"distinct1": distinct_n(hyps, 1), "distinct2": distinct_n(hyps, 2)}
    out.update(lyric_stats(hyp_lines))
    if ref_path:
        with open(ref_path, encoding="utf-8") as f:
            ref_lines = [l.rstrip("\n") for l in f if l.strip()]
        if len(ref_lines) == len(hyp_lines):
            refs = [[tokenize_lyric(l)] for l in ref_lines]
        else:
            # n_samples hypotheses per reference (generate.py layout)
            k = len(hyp_lines) // max(len(ref_lines), 1)
            if k * len(ref_lines) != len(hyp_lines):
                raise ValueError(
                    f"{len(hyp_lines)} hypotheses vs {len(ref_lines)} "
                    "references: not an integer multiple"
                )
            refs = [[tokenize_lyric(ref_lines[i // k])] for i in range(len(hyp_lines))]
        out.update(corpus_bleu(hyps, refs))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="MMTG automatic metrics")
    p.add_argument("--hyp", required=True, help="generated lyrics, one per line")
    p.add_argument("--ref", default="", help="reference lyrics (optional)")
    args = p.parse_args(argv)
    print(json.dumps(evaluate_files(args.hyp, args.ref or None), indent=2))


if __name__ == "__main__":
    main()
