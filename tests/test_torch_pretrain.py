"""Phase-1 pretraining in the port: ``pack_corpus`` equal to the JAX
package's, the LM loss equal on the same parameters, and the CLI on the CPU
writing a file that the trainer's ``--gpt2_ckpt`` loader reads."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtg_tpu import pretrain as jpre
from mmtg_tpu.configs import GPT2Config as JGPT2Config
from mmtg_tpu_torch import params as tparams
from mmtg_tpu_torch import pretrain as tpre
from mmtg_tpu_torch import train as ttrain
from mmtg_tpu_torch.configs import GPT2Config, ModelConfig

from _torch_parity import to_port_config

torch.set_num_threads(2)
JCFG = JGPT2Config(vocab_size=200, n_positions=64, n_embd=32, n_layer=2, n_head=4)
LINES = ["青山一道同云雨", "明月何曾是两乡", "", "海内存知己", "天涯若比邻",
         "一二三四五六七八九十一二三四五六七八九十"]


@pytest.fixture(scope="module")
def port_tokenizer(reference_vocab_path):
    from mmtg_tpu_torch.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_file(reference_vocab_path)


@pytest.mark.parametrize("seq_len", [16, 32, 128])
def test_pack_corpus_equal(tokenizer, port_tokenizer, seq_len):
    ref = jpre.pack_corpus(LINES, tokenizer, seq_len)
    got = tpre.pack_corpus(LINES, port_tokenizer, seq_len)
    assert got.dtype == ref.dtype == np.int32 and got.shape[1] == seq_len
    np.testing.assert_array_equal(got, ref)
    assert (got != 0).any(axis=1).all()  # no all-PAD rows


def test_lm_loss_matches_jax_and_ignores_the_pad_tail():
    cfg = to_port_config(JCFG)
    params = tparams.init_gpt2_params(cfg, seed=0)
    jparams = {k: (jnp.asarray(v.numpy()) if k != "h" else
                   {n: jnp.asarray(w.numpy()) for n, w in v.items()})
               for k, v in params.items()}
    ids = np.asarray([[1, 5, 6, 2, 1, 9, 7, 2, 0, 0, 0, 0],
                      [1, 8, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    ref = float(jpre.lm_loss(jparams, JCFG, jnp.asarray(ids)))
    got = float(tpre.lm_loss(params, cfg, torch.from_numpy(ids)))
    assert got == pytest.approx(ref, abs=1e-5) and got > 0
    longer = np.pad(ids, ((0, 0), (0, 6)))
    assert float(tpre.lm_loss(params, cfg, torch.from_numpy(longer))) == pytest.approx(
        got, rel=1e-5)


def test_pretrain_cli_learns_and_its_file_loads_as_gpt2_ckpt(tmp_path, reference_vocab_path,
                                                             port_tokenizer, monkeypatch):
    corpus = tmp_path / "lyrics.txt"
    corpus.write_text("\n".join(LINES[:5] * 8), encoding="utf-8")
    cfg = GPT2Config(vocab_size=len(port_tokenizer), n_positions=64, n_embd=32,
                     n_layer=2, n_head=4)
    losses = []
    real = tpre.lm_loss

    def spy(*a, **kw):
        out = real(*a, **kw)
        losses.append(float(out.detach()))
        return out

    monkeypatch.setattr(tpre, "lm_loss", spy)
    save = str(tmp_path / "phase1")
    tpre.main(["--corpus", str(corpus), "--vocab_path", reference_vocab_path,
               "--save_path", save, "--batch_size", "4", "--seq_len", "32",
               "--epochs", "6", "--lr", "3e-3", "--log_interval", "1",
               "--device", "cpu"], cfg=cfg)
    assert len(losses) >= 6 and np.isfinite(losses).all()
    assert min(losses[-3:]) < losses[0]  # the LM learns
    assert os.listdir(save) == ["pytorch_model.bin"]
    # the phase-2 trainer's loader reads it (a directory, or the file itself)
    mcfg = ModelConfig(gpt2=cfg)
    sd = torch.load(os.path.join(save, "pytorch_model.bin"), map_location="cpu")
    for path in (save, os.path.join(save, "pytorch_model.bin")):
        dst = tparams.init_params(mcfg, seed=9)
        before = dst["gpt2"]["wte"].clone()
        ttrain.load_gpt2_ckpt_into(dst, path, mcfg)
        assert not torch.equal(dst["gpt2"]["wte"], before)
        assert torch.equal(dst["gpt2"]["wte"], sd["transformer.wte.weight"])
        assert torch.equal(dst["gpt2"]["h"]["attn_w"][1],
                           sd["transformer.h.1.attn.c_attn.weight"])
    with pytest.raises(ValueError, match="model_config_json"):
        ttrain.load_gpt2_ckpt_into(dst, save, ModelConfig(gpt2=GPT2Config(
            vocab_size=77, n_embd=32, n_layer=2, n_head=4)))


def test_pretrain_cli_without_device_flag_needs_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = tmp_path / "c.txt"
    corpus.write_text("青山\n", encoding="utf-8")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tpre.main(["--corpus", str(corpus), "--vocab_path", "unused",
                   "--save_path", str(tmp_path / "x")])


def test_init_gpt2_params_is_the_gpt2_subtree_shape():
    cfg = to_port_config(JCFG)
    a = tparams.init_gpt2_params(cfg, seed=1)
    b = tparams.init_params(ModelConfig(gpt2=cfg), seed=1)["gpt2"]
    assert a.keys() == b.keys() and a["h"].keys() == b["h"].keys()
    for k in a["h"]:
        assert a["h"][k].shape == b["h"][k].shape
    assert a["wte"].shape == (200, 32) and a["h"]["attn_w"].shape == (2, 32, 96)
