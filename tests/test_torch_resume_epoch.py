"""--resume starts at the epoch the train state saved: a packed run (whose
epoch has fewer steps than the unpacked count ``epoch_for_step`` assumes)
resumed after its first epoch runs the second epoch alone, and a state saved
without an epoch (``scripts/orbax_to_torch.py``'s) still resumes by its
step. On the CPU, with a tiny model."""

import logging
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmtg_tpu_torch import train as cli
from mmtg_tpu_torch.checkpoint import restore_train_state, save_train_state
from mmtg_tpu_torch.data import make_synthetic_records

from _torch_parity import to_port_config, train_configs

torch.set_num_threads(2)

PACK = ("--pack_sequences", "--pack_row_len", "512", "--pack_slots", "8",
        "--pack_rows", "4")


@pytest.fixture(scope="module")
def cfgs():
    mcfg, dcfg = train_configs()
    return to_port_config(mcfg), to_port_config(dcfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory, cfgs):
    d = tmp_path_factory.mktemp("resume_epoch")
    rng = np.random.default_rng(0)
    paths = {}
    for name, n in (("train", 8), ("val", 4)):
        paths[name] = str(d / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(make_synthetic_records(n, rng, emb_size=cfgs[1].wenlan_emb_size), f)
    paths["emb"] = str(d / "emb.pkl")
    with open(paths["emb"], "wb") as f:
        pickle.dump({i: rng.standard_normal(cfgs[1].wenlan_emb_size).astype(np.float32)
                     for i in range(0, 13317, 7)}, f)
    return d, paths


@pytest.fixture
def small_vocab(monkeypatch, cfgs):
    """Fold the real vocab's ids into the tiny model's tables."""
    from mmtg_tpu_torch import data

    real = data.MMTGDataset._build

    def build(self, raw, tokenizer, cfg, if_train, seq_len):
        real(self, raw, tokenizer, cfg, if_train, seq_len)
        for k in ("topic_ids", "targets"):
            np.minimum(self._cols[k], cfgs[0].gpt2.vocab_size - 1, out=self._cols[k])

    monkeypatch.setattr(data.MMTGDataset, "_build", build)
    monkeypatch.setattr(
        data, "load_token_embedding_table",
        lambda path, vocab, emb: np.random.default_rng(1).standard_normal(
            (cfgs[0].gpt2.vocab_size, emb)).astype(np.float32))


def _args(files, vocab, save, *extra):
    _, p = files
    return ["--train_data_path", p["train"], "--val_data_path", p["val"],
            "--vocab_path", vocab, "--token_emb_path", p["emb"],
            "--batch_size", "4", "--val_batch_size", "4", "--lr", "1e-3",
            "--curriculums", "0,0", "--alpha", "0.2", "--log_interval", "1",
            "--save_model", "--save_path", save, "--device", "cpu",
            "--dtype", "float32", *extra]


def _epochs_run(caplog):
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("Epoch ") and "stage" in r.getMessage()]


def _newest(save):
    d = os.path.join(save, "train_state")
    return os.path.join(d, sorted(os.listdir(d))[-1])


def test_packed_resume_starts_the_next_epoch(files, reference_vocab_path, cfgs,
                                             small_vocab, caplog):
    """8 samples pack into one step an epoch (four rows of 512), where the
    unpacked count is two: ``epoch_for_step`` would map step 1 back into epoch
    0 and replay it. The saved epoch (1) sends the resumed run to epoch 2 of 2
    alone, and the state it writes then saves epoch 2."""
    save = str(files[0] / "packed")
    cli.main(_args(files, reference_vocab_path, save, "--epochs", "1", *PACK),
             mcfg=cfgs[0], dcfg=cfgs[1])
    first = torch.load(_newest(save), weights_only=True)
    assert first["epoch"] == 1
    assert cli.epoch_for_step(first["step"], 8, 4, (0, 0), 2) == 0  # the fault
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mmtg_tpu_torch"):
        cli.main(_args(files, reference_vocab_path, save, "--epochs", "2", "--resume",
                       *PACK), mcfg=cfgs[0], dcfg=cfgs[1])
    assert [m.split(" (")[0] for m in _epochs_run(caplog)] == ["Epoch 2/2"]
    second = torch.load(_newest(save), weights_only=True)
    assert second["epoch"] == 2 and second["step"] == 2 * first["step"]


def test_state_without_epoch_resumes_by_its_step(files, reference_vocab_path, cfgs,
                                                 small_vocab, caplog):
    """A state saved with no epoch at step 2 (8 rows at batch 4: the end of
    epoch 0 unpacked) resumes at epoch 1, as ``epoch_for_step`` maps it."""
    save = str(files[0] / "no_epoch")
    cli.main(_args(files, reference_vocab_path, save, "--epochs", "1"),
             mcfg=cfgs[0], dcfg=cfgs[1])
    path = _newest(save)
    raw = torch.load(path, weights_only=True)
    assert raw["step"] == 2 and raw.pop("epoch") == 1
    torch.save(raw, path)  # as scripts/orbax_to_torch.py writes it: no epoch
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mmtg_tpu_torch"):
        cli.main(_args(files, reference_vocab_path, save, "--epochs", "2", "--resume"),
                 mcfg=cfgs[0], dcfg=cfgs[1])
    assert [m.split(" (")[0] for m in _epochs_run(caplog)] == ["Epoch 2/2"]
    assert any("Resumed from step 2 (epoch 1)" in r.getMessage() for r in caplog.records)


class _State(SimpleNamespace):
    """A stand-in train state: params, AdamW state, step and generator."""

    def _replace(self, **kw):
        return _State(**{**vars(self), **kw})


def _state(value: float) -> _State:
    return _State(params={"w": torch.full((2,), value)},
                  opt_state={"count": torch.full((), value)}, step=0,
                  rng=torch.Generator().manual_seed(0))


def test_restore_returns_the_saved_epoch(tmp_path):
    """``with_epoch`` gives the saved epoch, ``None`` where none was saved,
    and ``(-1, None)`` for an empty directory; the two-value form stays."""
    saved = _state(1.0)._replace(step=3)
    save_train_state(str(tmp_path / "a"), 3, saved, epoch=4)
    save_train_state(str(tmp_path / "b"), 3, saved)
    for sub, want in (("a", 4), ("b", None)):
        got, step, epoch = restore_train_state(str(tmp_path / sub), _state(0.0),
                                               with_epoch=True)
        assert (step, epoch) == (3, want) and torch.equal(got.params["w"], torch.ones(2))
        assert restore_train_state(str(tmp_path / sub), _state(0.0))[1] == 3
    assert restore_train_state(str(tmp_path / "none"), _state(0.0),
                               with_epoch=True)[1:] == (-1, None)
