"""The port's own copy of the automatic metrics vs ``mmtg_tpu.eval`` on the
same inputs and the same files, and its CLI."""

import json

import pytest

from mmtg_tpu import eval as jeval
from mmtg_tpu_torch import eval as teval

HYPS = [list("青山一道同云雨"), list("明月何曾是两乡"), list("abcd"), list("a")]
REFS = [[list("青山一道"), list("同云雨共风雪")], [list("明月何曾是两乡啊")],
        [list("wxyz")], [list("ab")]]


@pytest.mark.parametrize("max_n", [1, 2, 4])
def test_corpus_bleu_equal(max_n):
    assert teval.corpus_bleu(HYPS, REFS, max_n=max_n) == jeval.corpus_bleu(
        HYPS, REFS, max_n=max_n)


def test_bleu_hand_computed():
    res = teval.corpus_bleu([list("abcd")], [[list("abce")]])
    assert res["p1"] == pytest.approx(3 / 4) and res["p2"] == pytest.approx(2 / 3)
    assert teval.corpus_bleu([list("aaaa")], [[list("bbbb")]])["bleu1"] == 0.0
    with pytest.raises(ValueError):
        teval.corpus_bleu(HYPS, REFS[:2])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_distinct_n_equal(n):
    assert teval.distinct_n(HYPS, n) == jeval.distinct_n(HYPS, n)
    assert teval.distinct_n([list("abab")], 2) == pytest.approx(2 / 3)


def test_tokenize_and_stats_equal():
    lines = ["青山一道，明月何曾", "海内存知己", "", "天涯，，若比邻"]
    for line in lines:
        assert teval.tokenize_lyric(line) == jeval.tokenize_lyric(line)
    assert teval.lyric_stats(lines) == jeval.lyric_stats(lines)
    assert teval.tokenize_lyric("青山，明月") == ["青", "山", "明", "月"]


@pytest.mark.parametrize("with_ref", [False, True], ids=["hyp_only", "with_ref"])
def test_evaluate_files_equal_on_the_same_files(tmp_path, with_ref):
    hyp, ref = tmp_path / "hyp.txt", tmp_path / "ref.txt"
    # 2 references x 2 samples each, the generate CLI's layout
    hyp.write_text("青山一道，同云雨\n青山一道\n\n明月何曾，是两乡\n明月几时有\n",
                   encoding="utf-8")
    ref.write_text("青山一道同云雨\n明月何曾是两乡\n", encoding="utf-8")
    r = str(ref) if with_ref else None
    got = teval.evaluate_files(str(hyp), r)
    assert got == jeval.evaluate_files(str(hyp), r)
    assert ("bleu4" in got) == with_ref and 0 < got["distinct1"] <= 1


def test_evaluate_files_mismatch_raises_and_cli_prints_json(tmp_path, capsys):
    hyp, ref = tmp_path / "hyp.txt", tmp_path / "ref.txt"
    hyp.write_text("a\nb\nc\n", encoding="utf-8")
    ref.write_text("a\nb\n", encoding="utf-8")
    with pytest.raises(ValueError):
        teval.evaluate_files(str(hyp), str(ref))
    ref.write_text("a\nb\nd\n", encoding="utf-8")
    teval.main(["--hyp", str(hyp), "--ref", str(ref)])
    out = json.loads(capsys.readouterr().out)
    assert out == teval.evaluate_files(str(hyp), str(ref))
    assert out["lyrics"] == 3 and out["p1"] == pytest.approx(2 / 3)
