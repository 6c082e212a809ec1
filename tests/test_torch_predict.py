"""The port's REPL (``python -m mmtg_tpu_torch.predict``) on the CPU at a tiny
size against the JAX package's REPL: fed ``0`` then ``q`` on stdin, with the
same seed, flags and checkpoint, it prints the same lyric lines, with and
without the swap probe."""

import io
import pickle

import numpy as np
import pytest
import torch

from mmtg_tpu import predict as jpredict
from mmtg_tpu.data import make_synthetic_records
from mmtg_tpu_torch import predict
from mmtg_tpu_torch.checkpoint import save_reference_checkpoint
from mmtg_tpu_torch.params import init_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def files(tmp_path_factory, tiny_model_cfg, tiny_data_cfg):
    d = tmp_path_factory.mktemp("predict")
    model = str(d / "model.pth")
    save_reference_checkpoint(model, init_params(tiny_model_cfg, seed=0),
                              tiny_model_cfg)
    rng = np.random.default_rng(0)
    records = make_synthetic_records(2, rng, emb_size=tiny_data_cfg.wenlan_emb_size)
    for r in records:
        r.pop("rating")
    data = str(d / "test.pkl")
    with open(data, "wb") as f:
        pickle.dump(records, f)
    emb = str(d / "emb.pkl")
    with open(emb, "wb") as f:
        pickle.dump({i: rng.standard_normal(tiny_data_cfg.wenlan_emb_size)
                     .astype(np.float32) for i in range(0, 13317, 5)}, f)
    return d, model, data, emb


def _argv(files, vocab, *extra):
    _, model, data, emb = files
    return ["--data_path", data, "--model_path", model, "--tokenizer_path", vocab,
            "--token_emb_path", emb, "--n_samples", "2", "--seed", "7", *extra]


def _run(main, monkeypatch, capsys, stdin="0\nq\n"):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    main()
    return capsys.readouterr().out


def _lyrics(out):
    return [line for line in out.splitlines() if line.startswith("  [")]


@pytest.fixture(scope="module")
def jax_swap_output(files, reference_vocab_path, tiny_model_cfg, tiny_data_cfg):
    """The JAX REPL at the tiny size, with the swap probe."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MMTG_COMPILATION_CACHE", str(files[0] / "jax_cache"))
        mp.setattr(jpredict, "ModelConfig", lambda: tiny_model_cfg)
        mp.setattr(jpredict, "DataConfig", lambda: tiny_data_cfg)
        mp.setattr("sys.stdin", io.StringIO("0\nq\n"))
        buf = io.StringIO()
        mp.setattr("sys.stdout", buf)
        jpredict.main(_argv(files, reference_vocab_path, "--swap_probe"))
    finally:
        mp.undo()
    return buf.getvalue()


@pytest.mark.parametrize("swap", [False, True], ids=["plain", "swap_probe"])
def test_repl_prints_the_jax_repl_lyrics(files, reference_vocab_path, tiny_model_cfg,
                                         tiny_data_cfg, jax_swap_output, monkeypatch,
                                         capsys, swap):
    """int8 weights and cache, as 'auto' resolves at 2 samples on both sides;
    the port draws from threefry keys split off the seed's key, as the JAX
    REPL splits its key per call."""
    extra = ("--swap_probe",) if swap else ()
    out = _run(lambda: predict.main(
        _argv(files, reference_vocab_path, "--device", "cpu", *extra),
        mcfg=tiny_model_cfg, dcfg=tiny_data_cfg), monkeypatch, capsys)
    want = _lyrics(jax_swap_output)
    assert len(want) == 4 and all(len(line) > 12 for line in want)
    got = _lyrics(out)
    assert got == (want if swap else want[:2])
    assert ("swap probe: steps 1 ↔ 3" in out) == swap
    assert "topic:" in out and out.count("idx> ") == 2


def test_repl_rejects_an_index_out_of_range(files, reference_vocab_path,
                                            tiny_model_cfg, tiny_data_cfg,
                                            monkeypatch, capsys):
    out = _run(lambda: predict.main(
        _argv(files, reference_vocab_path, "--device", "cpu"),
        mcfg=tiny_model_cfg, dcfg=tiny_data_cfg), monkeypatch, capsys,
        stdin="7\nabc\n")  # then end of input
    assert out.count("Please enter an index in [0, 2).") == 2
    assert _lyrics(out) == []


def test_repl_needs_a_card_unless_asked_for_the_cpu(files, reference_vocab_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict.main(_argv(files, reference_vocab_path))


def test_swap_steps_swaps_exactly_two_steps():
    rng = np.random.default_rng(3)
    row = {"img_embs": rng.standard_normal((5, 4)).astype(np.float32),
           "r_embs": rng.standard_normal((5, 4)).astype(np.float32),
           "topic_ids": np.arange(15, dtype=np.int32)}
    got = predict._swap_steps(row, 1, 3)
    want = jpredict._swap_steps(row, 1, 3)
    for k in row:
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("img_embs", "r_embs"):
        np.testing.assert_array_equal(got[k][[0, 2, 4]], row[k][[0, 2, 4]])
        np.testing.assert_array_equal(got[k][1], row[k][3])
        np.testing.assert_array_equal(got[k][3], row[k][1])
    np.testing.assert_array_equal(got["topic_ids"], row["topic_ids"])
    assert not np.shares_memory(got["img_embs"], row["img_embs"])
