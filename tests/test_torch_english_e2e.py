"""The English variant end to end on the port, on the CPU at a tiny size
(the port's counterpart of ``tests/test_english_e2e.py``): a byte-level BPE
vocab trained in the test, CLIP-width records, the train CLI (curriculum
objective, a ``model.safetensors`` bootstrap through ``--gpt2_ckpt``, a
``--profile_dir`` trace), the generate CLI on what it saved, and ``eval``'s
BLEU / distinct over readable English. Also the hand-written safetensors
reader and writer against the ``safetensors`` package (which the port does
not import)."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from mmtg_tpu_torch import checkpoint as tckpt
from mmtg_tpu_torch import eval as teval
from mmtg_tpu_torch import generate as gen_cli
from mmtg_tpu_torch import train as train_cli
from mmtg_tpu_torch.bpe import ByteLevelBPETokenizer, train_bpe
from mmtg_tpu_torch.configs import GPT2Config, english_variant
from mmtg_tpu_torch.data import make_synthetic_records
from mmtg_tpu_torch.decoding import postprocess_tokens
from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2
from mmtg_tpu_torch.params import init_gpt2_params, init_params, to_numpy, tree_leaves

torch.set_num_threads(2)

ENGLISH_CORPUS = [
    "city lights are calling out my name tonight",
    "we dance until the morning sun comes up",
    "every heartbeat echoes down the empty street",
    "hold me closer while the music plays",
    "summer rain keeps falling on my mind",
    "chasing shadows through the neon glow",
    "your voice is like a melody I know",
    "we were young and running with the wind",
    "golden hours fade into the night",
    "take my hand and never let it go",
]
CLIP_DIM = 64


@pytest.fixture(scope="module")
def english_setup(tmp_path_factory):
    """BPE vocab dir, English pkl fixtures, a CLIP-width embedding table."""
    root = tmp_path_factory.mktemp("english")
    tok = train_bpe(ENGLISH_CORPUS, vocab_size=600)
    tok.save(str(root / "bpe_vocab"))
    rng = np.random.default_rng(0)
    records = make_synthetic_records(32, rng, emb_size=CLIP_DIM,
                                     lyrics_pool=ENGLISH_CORPUS)
    with open(root / "train.pkl", "wb") as f:
        pickle.dump(records, f)
    test_records = make_synthetic_records(2, rng, emb_size=CLIP_DIM,
                                          lyrics_pool=ENGLISH_CORPUS, topic="city")
    for r in test_records:
        r.pop("rating")
    with open(root / "test.pkl", "wb") as f:
        pickle.dump(test_records, f)
    with open(root / "emb.pkl", "wb") as f:
        pickle.dump({i: rng.standard_normal(CLIP_DIM).astype("float32")
                     for i in range(len(tok))}, f)
    return root, tok


@pytest.fixture(scope="module")
def english_cfgs(english_setup):
    """english_variant() dims with a 2-layer, 48-d GPT-2 and 32-d channels;
    every other English decision (CLIP channel inputs, projector widths,
    vocab) comes from english_variant() itself."""
    _, tok = english_setup
    mcfg, dcfg = english_variant(clip_dim=CLIP_DIM, gpt2_vocab=len(tok))
    mcfg = dataclasses.replace(
        mcfg,
        topic=dataclasses.replace(mcfg.topic, hidden_dim=32),
        image=dataclasses.replace(mcfg.image, hidden_dim=32),
        text=dataclasses.replace(mcfg.text, hidden_dim=32),
        self_att_hidden_size=32,
        gpt2=GPT2Config(vocab_size=len(tok), n_positions=256, n_ctx=250,
                        n_embd=48, n_layer=2, n_head=4),
    )
    return mcfg, dcfg


def test_english_variant_dims():
    mcfg, dcfg = english_variant(clip_dim=512, gpt2_vocab=50257)
    assert mcfg.topic.input_dim == mcfg.image.input_dim == mcfg.text.input_dim == 512
    assert mcfg.mm_att_out_dim == 512 and dcfg.wenlan_emb_size == 512
    assert mcfg.gpt2.vocab_size == 50257 and mcfg.gpt2.n_positions == 1024


def test_english_train_generate_eval(english_setup, english_cfgs, tmp_path):
    """Train from a model.safetensors snapshot (32 steps at batch 1, a
    profiler trace of steps 10-30), generate from the save path, score."""
    root, tok = english_setup
    mcfg, dcfg = english_cfgs
    assert ByteLevelBPETokenizer.from_dir(str(root / "bpe_vocab")).native is not None
    snapshot = tmp_path / "gpt2"
    snapshot.mkdir()
    gpt2 = init_gpt2_params(mcfg.gpt2, seed=5)
    tckpt.write_safetensors(str(snapshot / "model.safetensors"),
                            export_hf_gpt2(gpt2, mcfg.gpt2))
    save, trace = tmp_path / "ckpt", tmp_path / "trace"
    val = train_cli.main([
        "--variant", "english", "--clip_dim", str(CLIP_DIM), "--device", "cpu",
        "--batch_size", "1", "--val_batch_size", "8", "--epochs", "1",
        "--lr", "1e-3", "--curriculums", "[0,0]", "--log_interval", "8",
        "--val_interval_ratio", "1.0",
        "--train_data_path", str(root / "train.pkl"),
        "--val_data_path", str(root / "train.pkl"),
        "--vocab_path", str(root / "bpe_vocab"),
        "--token_emb_path", str(root / "emb.pkl"),
        "--gpt2_ckpt", str(snapshot), "--profile_dir", str(trace),
        "--save_model", "--save_path", str(save),
        "--alpha", "0.2", "--dtype", "float32",
    ], mcfg=mcfg, dcfg=dcfg)
    assert np.isfinite(val)
    assert os.listdir(save / "train_state") == ["step_00000032.pt"]
    traces = os.listdir(trace)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(trace / traces[0]) as f:
        assert json.load(f)["traceEvents"]

    out = tmp_path / "samples.txt"
    gen_cli.main([
        "--variant", "english", "--clip_dim", str(CLIP_DIM), "--device", "cpu",
        "--data_path", str(root / "test.pkl"), "--model_path", str(save),
        "--tokenizer_path", str(root / "bpe_vocab"),
        "--token_emb_path", str(root / "emb.pkl"),
        "--batch_size", "4", "--n_samples", "2",
        "--save_samples", "--save_samples_path", str(out),
    ], mcfg=mcfg, dcfg=dcfg)
    lines = out.read_text(encoding="utf-8").splitlines()
    assert len(lines) == 4  # 2 test rows x 2 samples
    # readable text, not the BPE byte alphabet
    joined = "".join(lines)
    assert "Ġ" not in joined and "Ċ" not in joined

    ref = tmp_path / "ref.txt"
    ref.write_text("\n".join(["，".join(ENGLISH_CORPUS[:2])] * 2) + "\n",
                   encoding="utf-8")
    metrics = teval.evaluate_files(str(out), str(ref))
    assert 0.0 <= metrics["distinct1"] <= 1.0 and 0.0 <= metrics["distinct2"] <= 1.0
    assert all(0.0 <= metrics[f"bleu{n}"] <= 1.0 for n in (1, 2, 3, 4))


def test_english_postprocess_readable(english_setup):
    """BPE rows decode through the byte alphabet: words come back as typed,
    sentences '，'-joined."""
    _, tok = english_setup
    ids = ([tok.vocab["[#START#]"]] + tok.encode("hold me closer")
           + [tok.vocab["[#EOS#]"], tok.vocab["[#START#]"]]
           + tok.encode("golden hours") + [tok.vocab["[#EOS#]"], tok.sep_token_id])
    assert postprocess_tokens(ids, tok) == "hold me closer，golden hours"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_and_writer_against_the_package(tmp_path, dtype):
    """The writer's file reads back through the safetensors package and the
    reader reads the package's file, tensor for tensor (numpy has no bf16:
    the package's torch half checks that type)."""
    import safetensors.numpy
    import safetensors.torch

    rng = np.random.default_rng(1)
    tensors = {"b.w": torch.from_numpy(rng.standard_normal((3, 5))).to(dtype),
               "a.bias": torch.from_numpy(rng.standard_normal(7)).to(dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "scalar": torch.tensor(2.5, dtype=dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    ours = str(tmp_path / "ours.safetensors")
    tckpt.write_safetensors(ours, tensors)
    theirs = str(tmp_path / "theirs.safetensors")
    safetensors.torch.save_file(tensors, theirs, metadata={"format": "pt"})
    for got in (safetensors.torch.load_file(ours), tckpt.read_safetensors(theirs),
                tckpt.read_safetensors(ours)):
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(got[k], t), k
    if dtype != torch.bfloat16:
        arrays = safetensors.numpy.load_file(ours)
        for k, t in tensors.items():
            np.testing.assert_array_equal(arrays[k], t.numpy())
    with open(ours, "rb") as f:
        head = int.from_bytes(f.read(8), "little")
    assert head % 8 == 0
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes((10 ** 6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="runs past the file"):
        tckpt.read_safetensors(str(bad))


def test_gpt2_ckpt_directory_formats_load_the_same_tree(english_cfgs, tmp_path):
    """A snapshot directory with model.safetensors (GPT2Model names, as the
    Hugging Face hub ships GPT-2) loads to the tree a pytorch_model.bin of
    the same weights gives, and to what safetensors.numpy reads; with both
    files present pytorch_model.bin is read, as in the JAX package."""
    import safetensors.numpy

    mcfg, _ = english_cfgs
    src = init_gpt2_params(mcfg.gpt2, seed=1)
    sd = export_hf_gpt2(src, mcfg.gpt2)
    st_dir, bin_dir = tmp_path / "st", tmp_path / "bin"
    st_dir.mkdir()
    bin_dir.mkdir()
    bare = {k[len("transformer."):]: v for k, v in sd.items()
            if k.startswith("transformer.")}
    tckpt.write_safetensors(str(st_dir / "model.safetensors"), bare)
    torch.save(sd, str(bin_dir / "pytorch_model.bin"))
    trees = []
    for d in (st_dir, bin_dir):
        params = init_params(mcfg, seed=9)
        train_cli.load_gpt2_ckpt_into(params, str(d), mcfg)
        trees.append(to_numpy(params["gpt2"]))
    arrays = safetensors.numpy.load_file(str(st_dir / "model.safetensors"))
    np.testing.assert_array_equal(trees[0]["wte"], arrays["wte.weight"])
    np.testing.assert_array_equal(trees[0]["h"]["attn_w"][1],
                                  arrays["h.1.attn.c_attn.weight"])
    for a, b in zip(tree_leaves(trees[0]), tree_leaves(trees[1])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(trees[0]), tree_leaves(to_numpy(src))):
        np.testing.assert_array_equal(a, b)
    # both files: the .bin wins
    other = export_hf_gpt2(init_gpt2_params(mcfg.gpt2, seed=2), mcfg.gpt2)
    torch.save(other, str(st_dir / "pytorch_model.bin"))
    params = init_params(mcfg, seed=9)
    train_cli.load_gpt2_ckpt_into(params, str(st_dir), mcfg)
    assert torch.equal(params["gpt2"]["wte"], other["transformer.wte.weight"])

