"""The port's train CLI end to end on the CPU with a tiny model: one epoch
writes a train-state checkpoint, --resume continues from it (on parity rows
and with --pack_sequences), the unported flags raise, and without --device a
machine with no GPU gets an error."""

import os
import pickle

import numpy as np
import pytest
import torch

from mmtg_tpu_torch import generate as gen_cli
from mmtg_tpu_torch import train as cli
from mmtg_tpu_torch.checkpoint import restore_train_state, save_train_state
from mmtg_tpu_torch.configs import TrainConfig
from mmtg_tpu_torch.data import make_synthetic_records
from mmtg_tpu_torch.params import tree_leaves

from _torch_parity import to_port_config, train_configs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfgs():
    mcfg, dcfg = train_configs()
    return to_port_config(mcfg), to_port_config(dcfg)


@pytest.fixture(scope="module")
def files(tmp_path_factory, cfgs):
    d = tmp_path_factory.mktemp("train_cli")
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


def _args(files, vocab, save, *extra):
    _, p = files
    return ["--train_data_path", p["train"], "--val_data_path", p["val"],
            "--vocab_path", vocab, "--token_emb_path", p["emb"],
            "--batch_size", "4", "--val_batch_size", "4", "--lr", "1e-3",
            "--curriculums", "0,0", "--alpha", "0.2", "--log_interval", "1",
            "--save_model", "--save_path", save, "--device", "cpu", *extra]


class _SmallVocab:
    """Fold the real vocab's ids into the tiny model's 200-row tables."""

    def __init__(self, monkeypatch, cfgs):
        from mmtg_tpu_torch import data

        real = data.MMTGDataset._build

        def build(self, raw, tokenizer, cfg, if_train, seq_len):
            real(self, raw, tokenizer, cfg, if_train, seq_len)
            for k in ("topic_ids", "targets"):
                np.minimum(self._cols[k], cfgs[0].gpt2.vocab_size - 1,
                           out=self._cols[k])

        monkeypatch.setattr(data.MMTGDataset, "_build", build)
        monkeypatch.setattr(
            data, "load_token_embedding_table",
            lambda path, vocab, emb: np.random.default_rng(1).standard_normal(
                (cfgs[0].gpt2.vocab_size, emb)).astype(np.float32))


def test_train_one_epoch_then_resume(files, reference_vocab_path, cfgs, monkeypatch):
    _SmallVocab(monkeypatch, cfgs)
    save = str(files[0] / "ckpt")
    val = cli.main(_args(files, reference_vocab_path, save, "--epochs", "1",
                         "--dtype", "float32"), mcfg=cfgs[0], dcfg=cfgs[1])
    assert np.isfinite(val)
    ckpts = sorted(os.listdir(os.path.join(save, "train_state")))
    assert ckpts == ["step_00000002.pt"]  # 8 rows / batch 4
    assert os.listdir(os.path.join(save, "train_state_best"))
    # a second epoch, resumed: starts at epoch 1 (step 2), ends at step 4
    val2 = cli.main(_args(files, reference_vocab_path, save, "--epochs", "2",
                          "--dtype", "bfloat16", "--grad_accum", "2", "--resume"),
                    mcfg=cfgs[0], dcfg=cfgs[1])
    assert np.isfinite(val2)
    ckpts = sorted(os.listdir(os.path.join(save, "train_state")))
    assert ckpts == ["step_00000002.pt", "step_00000004.pt"]
    # and a finished run has nothing left to train
    cli.main(_args(files, reference_vocab_path, save, "--epochs", "2", "--resume"),
             mcfg=cfgs[0], dcfg=cfgs[1])
    assert sorted(os.listdir(os.path.join(save, "train_state"))) == ckpts
    # the generate CLI takes the save path the trainer wrote
    out = str(files[0] / "samples.txt")
    gen_cli.main(["--data_path", files[1]["val"], "--model_path", save,
                  "--tokenizer_path", reference_vocab_path, "--token_emb_path",
                  files[1]["emb"], "--batch_size", "4", "--n_samples", "1",
                  "--save_samples", "--save_samples_path", out, "--device", "cpu"],
                 mcfg=cfgs[0], dcfg=cfgs[1])
    with open(out, encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 4  # one line per val row


def test_train_packed_one_epoch_then_resume(files, reference_vocab_path, cfgs,
                                            monkeypatch, caplog):
    """--pack_sequences through an epoch and --resume: 8 samples pack into
    rows of 256 (at most 4 per row), two rows per step."""
    import logging

    _SmallVocab(monkeypatch, cfgs)
    save = str(files[0] / "ckpt_packed")
    pack = ("--pack_sequences", "--pack_row_len", "256", "--pack_slots", "4",
            "--pack_rows", "2")
    with caplog.at_level(logging.INFO, logger="mmtg_tpu_torch"):
        val = cli.main(_args(files, reference_vocab_path, save, "--epochs", "1",
                             "--dtype", "float32", *pack), mcfg=cfgs[0], dcfg=cfgs[1])
    assert np.isfinite(val)
    assert any("Sequence packing ON" in r.getMessage() for r in caplog.records)
    first = sorted(os.listdir(os.path.join(save, "train_state")))
    assert len(first) == 1
    steps = int(first[0][len("step_"):-len(".pt")])
    assert 1 <= steps <= 4  # 8 samples, at least 2 and at most 8 per step
    val2 = cli.main(_args(files, reference_vocab_path, save, "--epochs", "2",
                          "--dtype", "bfloat16", "--grad_accum", "2", "--resume",
                          *pack), mcfg=cfgs[0], dcfg=cfgs[1])
    assert np.isfinite(val2)
    second = sorted(os.listdir(os.path.join(save, "train_state")))
    assert len(second) == 2 and second[0] == first[0]


def test_train_packed_rows_default_follows_the_token_budget(files, reference_vocab_path,
                                                            cfgs, monkeypatch, caplog):
    """--pack_rows 0: rows per step come from the batch's token budget (at
    least 8, a multiple of 8), and a row too short for a sample raises."""
    _SmallVocab(monkeypatch, cfgs)
    save = str(files[0] / "ckpt_packed_auto")
    val = cli.main(_args(files, reference_vocab_path, save, "--epochs", "1",
                         "--dtype", "float32", "--pack_sequences"),
                   mcfg=cfgs[0], dcfg=cfgs[1])
    assert np.isfinite(val)
    # one step of 8 rows holds all 8 samples
    assert sorted(os.listdir(os.path.join(save, "train_state"))) == ["step_00000001.pt"]
    with pytest.raises(ValueError, match="pack_row_len"):
        cli.main(_args(files, reference_vocab_path, save, "--pack_sequences",
                       "--pack_row_len", "32"), mcfg=cfgs[0], dcfg=cfgs[1])


@pytest.mark.parametrize("extra", [
    ("--mesh_data", "2"), ("--mesh_model", "2"), ("--mesh_pipe", "2"),
    ("--zero1",), ("--multihost",), ("--pack_sequences", "--mesh_model", "2"),
    ("--profile_dir", "trace"),
])
def test_train_cli_unported_flags_raise(files, reference_vocab_path, cfgs, extra,
                                        monkeypatch):
    """Meshes, ZeRO-1 and multihost raise. ``--profile_dir`` is ported: it
    traces steps 10-30 of the first epoch, so this epoch of fewer steps
    trains and writes no trace (tests/test_torch_english_e2e.py writes one)."""
    if extra[0] == "--profile_dir":
        _SmallVocab(monkeypatch, cfgs)
        trace = files[0] / "trace"
        val = cli.main(_args(files, reference_vocab_path, str(files[0] / "x"),
                             "--epochs", "1", "--dtype", "float32", extra[0],
                             str(trace)), mcfg=cfgs[0], dcfg=cfgs[1])
        assert np.isfinite(val) and not trace.exists()
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(_args(files, reference_vocab_path, str(files[0] / "x"), *extra),
                 mcfg=cfgs[0], dcfg=cfgs[1])


def test_train_cli_rejects_indivisible_grad_accum(files, reference_vocab_path, cfgs):
    with pytest.raises(ValueError, match="grad_accum"):
        cli.main(_args(files, reference_vocab_path, str(files[0] / "x"),
                       "--grad_accum", "3"), mcfg=cfgs[0], dcfg=cfgs[1])


@pytest.mark.parametrize("main", [cli.main, gen_cli.main], ids=["train", "generate"])
def test_cli_without_device_flag_needs_a_gpu(main, monkeypatch):
    """No silent CPU run: the default device is the CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([])


def test_flag_names_and_defaults_match_the_jax_trainer():
    from mmtg_tpu.train import build_arg_parser as jax_parser

    ours = {a.dest: a.default for a in cli.build_arg_parser()._actions}
    theirs = {a.dest: a.default for a in jax_parser()._actions}
    assert set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device"}


def test_train_state_checkpoint_roundtrip_and_keep(tmp_path, cfgs):
    tcfg = TrainConfig()
    state, tx = cli.create_train_state(0, cfgs[0], tcfg, 1, 4, device="cpu")
    state.opt_state["count"].fill_(3)
    state.rng.manual_seed(99)
    for step in range(1, 8):
        save_train_state(str(tmp_path), step, state._replace(step=step))
    assert sorted(os.listdir(tmp_path)) == [f"step_{i:08d}.pt" for i in range(3, 8)]
    fresh, _ = cli.create_train_state(1, cfgs[0], tcfg, 1, 4, device="cpu")
    fresh, last = restore_train_state(str(tmp_path), fresh)
    assert last == 7 and fresh.step == 7 and int(fresh.opt_state["count"]) == 3
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(state.params)):
        assert torch.equal(a, b) and a.requires_grad
    assert torch.equal(fresh.rng.get_state(), state.rng.get_state())
    assert restore_train_state(str(tmp_path / "none"), fresh)[1] == -1


def test_library_entry_points_take_no_default_device(cfgs):
    # the caller names the device: no state or eval lands on the CPU unasked
    with pytest.raises(TypeError):
        cli.create_train_state(0, cfgs[0], TrainConfig(), 1, 4)
    with pytest.raises(TypeError):
        cli.evaluate(None, None, None, [], 1, 3)


@pytest.mark.parametrize("last_step,epoch", [(0, 0), (1, 0), (2, 1), (5, 1), (6, 2), (99, 3)])
def test_epoch_for_step(last_step, epoch):
    # 8 samples, batch 2: stage-1 epoch 0 has 2 steps (2x batch), later 4
    assert cli.epoch_for_step(last_step, 8, 2, (1, 3), 3) == epoch


def test_parse_curriculums():
    assert cli.parse_curriculums("[1,3]") == (1, 3) == cli.parse_curriculums("1, 3")
    with pytest.raises(ValueError):
        cli.parse_curriculums("1")


def test_load_gpt2_ckpt_into(tmp_path, cfgs):
    from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2
    from mmtg_tpu_torch.params import init_params

    src = init_params(cfgs[0], seed=1)
    dst = init_params(cfgs[0], seed=2)
    hf = str(tmp_path / "hf.pth")
    torch.save(export_hf_gpt2(src["gpt2"], cfgs[0].gpt2), hf)
    cli.load_gpt2_ckpt_into(dst, hf, cfgs[0])
    assert torch.equal(dst["gpt2"]["h"]["attn_w"], src["gpt2"]["h"]["attn_w"])
    # the reference's phase-1 decoder: gpt2.-prefixed + projectors
    sd = export_hf_gpt2(src["gpt2"], cfgs[0].gpt2, prefix="gpt2.")
    sd["projector_layer1.weight"] = src["projector1"]["w"].T.contiguous()
    sd["projector_layer1.bias"] = src["projector1"]["b"]
    sd["projector_layer2.weight"] = src["projector2"]["w"].T.contiguous()
    sd["projector_layer2.bias"] = src["projector2"]["b"]
    ref = str(tmp_path / "phase1.ckpt")
    torch.save({"state_dict": sd}, ref)
    dst = init_params(cfgs[0], seed=3)
    cli.load_gpt2_ckpt_into(dst, ref, cfgs[0])
    assert torch.equal(dst["gpt2"]["wte"], src["gpt2"]["wte"])
    assert torch.equal(dst["projector2"]["w"], src["projector2"]["w"])
    with pytest.raises(NotImplementedError):
        cli.load_gpt2_ckpt_into(dst, str(tmp_path), cfgs[0])
