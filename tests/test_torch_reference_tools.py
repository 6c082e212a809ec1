"""The port's ``export_reference_ckpt`` and ``parity_check`` on the CPU with
a tiny model: a trained run exports to a reference ``.pth`` that reads back
with equal parameters and holds, key for key and value for value, what the
JAX package's exporter writes for them; and ``parity_check --device cpu`` on
a synthetic ``.pth`` passes, its teacher-forced logits within 1e-5 of the
JAX package's on the same ``.pth``."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import checkpoint as jckpt
from mmtg_tpu.models.mmtg import mmtg_forward_train as jax_forward_train
from mmtg_tpu_torch import train as cli
from mmtg_tpu_torch.checkpoint import load_reference_checkpoint
from mmtg_tpu_torch.data import make_synthetic_records
from mmtg_tpu_torch.params import to_numpy, tree_leaves
from mmtg_tpu_torch.tools import export_reference_ckpt, parity_check

from _torch_parity import to_port_config, train_configs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfgs():
    jm, jd = train_configs()
    return jm, jd, to_port_config(jm), to_port_config(jd)


@pytest.fixture(scope="module")
def files(tmp_path_factory, cfgs):
    d = tmp_path_factory.mktemp("reference_tools")
    rng = np.random.default_rng(0)
    paths = {}
    for name, n in (("train", 8), ("val", 4)):
        paths[name] = str(d / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(make_synthetic_records(n, rng, emb_size=cfgs[3].wenlan_emb_size), f)
    paths["emb"] = str(d / "emb.pkl")
    with open(paths["emb"], "wb") as f:
        pickle.dump({i: rng.standard_normal(cfgs[3].wenlan_emb_size).astype(np.float32)
                     for i in range(0, 13317, 7)}, f)
    return d, paths


@pytest.fixture
def small_vocab(monkeypatch, cfgs):
    """Fold the real vocab's ids into the tiny model's tables."""
    from mmtg_tpu_torch import data

    real = data.MMTGDataset._build
    V = cfgs[2].gpt2.vocab_size

    def build(self, raw, tokenizer, cfg, if_train, seq_len):
        real(self, raw, tokenizer, cfg, if_train, seq_len)
        for k in ("topic_ids", "targets"):
            np.minimum(self._cols[k], V - 1, out=self._cols[k])

    monkeypatch.setattr(data.MMTGDataset, "_build", build)
    monkeypatch.setattr(
        data, "load_token_embedding_table",
        lambda path, vocab, emb: np.random.default_rng(1).standard_normal(
            (V, emb)).astype(np.float32))


def test_export_of_a_trained_run_round_trips(files, reference_vocab_path, cfgs,
                                             small_vocab, tmp_path, capsys):
    jm, _, mcfg, dcfg = cfgs
    d, p = files
    save = str(d / "run")
    cli.main(["--train_data_path", p["train"], "--val_data_path", p["val"],
              "--vocab_path", reference_vocab_path, "--token_emb_path", p["emb"],
              "--batch_size", "4", "--val_batch_size", "4", "--lr", "1e-3",
              "--curriculums", "0,0", "--alpha", "0.2", "--epochs", "1",
              "--save_model", "--save_path", save, "--device", "cpu",
              "--dtype", "float32"], mcfg=mcfg, dcfg=dcfg)
    ckpt = os.path.join(save, "train_state")
    out = str(tmp_path / "mmtg_ckpt.pth")
    assert export_reference_ckpt.main(["--ckpt", ckpt, "--out", out], mcfg=mcfg) == 0
    assert "exported step-2 params" in capsys.readouterr().out
    trained = torch.load(os.path.join(ckpt, sorted(os.listdir(ckpt))[-1]),
                         weights_only=True)["params"]
    raw = torch.load(out, map_location="cpu", weights_only=False)
    assert set(raw) == {"model", "args", "model_cfgs"}
    assert all(k.startswith("module.") for k in raw["model"])
    back = load_reference_checkpoint(out, mcfg)
    for a, b in zip(tree_leaves(back), tree_leaves(trained)):
        assert torch.equal(a, b.detach())
    want = jckpt.export_reference_state_dict(
        jax.tree.map(jnp.asarray, to_numpy(trained)), jm)
    got = {k[len("module."):]: v for k, v in raw["model"].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a directory without a train state
    empty = str(tmp_path / "none")
    os.makedirs(empty)
    assert export_reference_ckpt.main(["--ckpt", empty, "--out", out], mcfg=mcfg) == 1


def test_parity_check_on_the_cpu_matches_jax(files, reference_vocab_path, cfgs,
                                             small_vocab, tmp_path, capsys):
    jm, jd, mcfg, dcfg = cfgs
    _, p = files
    pth = str(tmp_path / "synthetic.pth")
    argv = ["--make-synthetic-ckpt", pth, "--ckpt", pth, "--data", p["val"],
            "--vocab", reference_vocab_path, "--token_emb_path", p["emb"],
            "--batch_size", "2", "--max_batches", "2", "--decode_prefix", "8",
            "--device", "cpu"]
    assert parity_check.main(argv, mcfg, dcfg) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] and rep["device"] == "cpu"
    assert set(rep["float32"]) == set(rep["bfloat16"]) == {"train", "infer", "decode"}
    assert rep["max_abs_logits_diff"] <= 1e-5
    assert len(rep["float32"]["train"]["per_batch"]) == 2
    # the port's teacher-forced logits against the JAX package's, same .pth
    args = parity_check.build_arg_parser().parse_args(argv[2:])  # the .pth as written
    params, table, batches, one = parity_check.load_inputs(args, mcfg, dcfg)
    ours = parity_check.surfaces(params, table, batches, one, mcfg, dcfg, "train", 8,
                                 "cpu", torch.float32)["train"]
    jparams = jckpt.load_reference_checkpoint(pth, jm)
    for batch, logits in zip(batches, ours):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = jax_forward_train(jparams, {"wenlan_table": jnp.asarray(table)}, jm, jd,
                                 jb, deterministic=True).logits
        np.testing.assert_allclose(logits, np.asarray(want), atol=1e-5, rtol=0)
