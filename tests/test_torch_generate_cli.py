"""The port's generate CLI end to end on the CPU: a tiny model saved as a
reference .pth, synthetic test rows and a token-embedding pkl in, one
sample per line out."""

import pickle

import numpy as np
import pytest
import torch

from mmtg_tpu.data import make_synthetic_records
from mmtg_tpu_torch import generate as cli
from mmtg_tpu_torch.checkpoint import save_reference_checkpoint
from mmtg_tpu_torch.params import init_params, tree_leaves

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def files(tmp_path_factory, tiny_model_cfg, tiny_data_cfg):
    d = tmp_path_factory.mktemp("cli")
    model = str(d / "model.pth")
    save_reference_checkpoint(model, init_params(tiny_model_cfg, seed=0),
                              tiny_model_cfg)
    rng = np.random.default_rng(0)
    records = make_synthetic_records(3, rng, emb_size=tiny_data_cfg.wenlan_emb_size)
    for r in records:
        r.pop("rating")
    data = str(d / "test.pkl")
    with open(data, "wb") as f:
        pickle.dump(records, f)
    emb = str(d / "emb.pkl")
    with open(emb, "wb") as f:
        pickle.dump({i: rng.standard_normal(tiny_data_cfg.wenlan_emb_size)
                     .astype(np.float32) for i in range(0, 13317, 7)}, f)
    return d, model, data, emb


def _args(files, reference_vocab_path, *extra):
    d, model, data, emb = files
    return ["--data_path", data, "--model_path", model,
            "--tokenizer_path", reference_vocab_path, "--token_emb_path", emb,
            "--device", "cpu", *extra]


def test_cli_writes_one_line_per_sample(files, reference_vocab_path,
                                        tiny_model_cfg, tiny_data_cfg):
    out = str(files[0] / "samples.txt")
    # batch 4 over 3 rows x 2 samples: the last batch is padded and cut
    cli.main(_args(files, reference_vocab_path, "--batch_size", "4",
                   "--n_samples", "2", "--save_samples",
                   "--save_samples_path", out),
             mcfg=tiny_model_cfg, dcfg=tiny_data_cfg)
    with open(out, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert len(lines) == 6
    assert all(line.strip() for line in lines)


@pytest.mark.parametrize("extra", [
    ("--mesh_data", "2"), ("--cache_dtype", "int4"), ("--attn_impl", "fused"),
    ("--topk_impl", "approx"),
])
def test_cli_unported_flags_raise(files, reference_vocab_path, tiny_model_cfg,
                                  tiny_data_cfg, extra):
    """A mesh flag without torchrun raises (a mesh needs one process a
    rank); the int4 cache and the whole-step kernel are ported, and write
    their samples; approximate top-k takes the exact top-k and writes the
    exact run's samples."""
    out = str(files[0] / f"samples_{extra[1]}.txt")
    run = lambda: cli.main(  # noqa: E731
        _args(files, reference_vocab_path, "--batch_size", "2", "--n_samples", "1",
              "--save_samples", "--save_samples_path", out, *extra),
        mcfg=tiny_model_cfg, dcfg=tiny_data_cfg)
    if extra[0] == "--mesh_data":
        with pytest.raises(RuntimeError, match="torchrun"):
            run()
        return
    run()
    with open(out, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert len(lines) == 3
    if extra[0] == "--topk_impl":
        exact = str(files[0] / "samples_exact.txt")
        cli.main(_args(files, reference_vocab_path, "--batch_size", "2", "--n_samples",
                       "1", "--save_samples", "--save_samples_path", exact),
                 mcfg=tiny_model_cfg, dcfg=tiny_data_cfg)
        with open(exact, encoding="utf-8") as f:
            assert f.read().splitlines() == lines


@pytest.mark.parametrize("extra", [
    ("--cache_dtype", "int4"), ("--cache_dtype", "int8", "--merged_kv"),
    ("--attn_impl", "fused", "--cache_dtype", "int8", "--weight_dtype", "model"),
], ids=["int4", "merged_kv", "fused"])
def test_cli_serving_decode_flags_run(files, reference_vocab_path, tiny_model_cfg,
                                      tiny_data_cfg, extra, monkeypatch):
    """--cache_dtype int4, --merged_kv and --attn_impl fused reach their
    paths: the cache handed to the decode step has the form asked for."""
    from mmtg_tpu_torch import decoding

    seen = []
    real = decoding.gpt2_decode_step

    def spy(params, cfg, cache, *args, **kw):
        seen.append((cache.kind(cfg.n_embd), cache.merged, kw.get("attn_impl")))
        return real(params, cfg, cache, *args, **kw)

    monkeypatch.setattr(decoding, "gpt2_decode_step", spy)
    out = str(files[0] / "samples_flags.txt")
    cli.main(_args(files, reference_vocab_path, "--batch_size", "2", "--n_samples",
                   "2", "--save_samples", "--save_samples_path", out, *extra),
             mcfg=tiny_model_cfg, dcfg=tiny_data_cfg)
    with open(out, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert len(lines) == 6 and all(line.strip() for line in lines)
    want = {"int4": ("int4", False, "kernel"), "merged_kv": ("int8", True, "kernel"),
            "fused": ("int8", False, "fused")}
    key = "merged_kv" if "--merged_kv" in extra else (
        "fused" if "fused" in extra else "int4")
    assert set(seen) == {want[key]}


def test_cli_rejects_orbax_dirs(files, reference_vocab_path, tiny_model_cfg,
                                tiny_data_cfg):
    """A directory with no train-state stream (an Orbax save path, or none
    at all) names what it looked in."""
    args = _args(files, reference_vocab_path)
    args[args.index("--model_path") + 1] = str(files[0])
    with pytest.raises(FileNotFoundError, match="train_state_best"):
        cli.main(args, mcfg=tiny_model_cfg, dcfg=tiny_data_cfg)


def _save_state(directory, params, step):
    from types import SimpleNamespace

    from mmtg_tpu_torch.checkpoint import save_train_state

    return save_train_state(directory, step, SimpleNamespace(
        params=params, opt_state={"count": torch.tensor(step)}, step=step,
        rng=torch.Generator()))


@pytest.mark.parametrize("form", ["both_streams", "epoch_stream", "step_file",
                                  "reference_pth", "empty_dir"])
def test_load_params_takes_what_train_writes(tmp_path, tiny_model_cfg, form):
    """``load_params`` reads a trainer's save path (the best-val stream
    preferred, its newest step), one ``step_*.pt`` and a reference ``.pth``,
    and raises on a directory with neither stream."""
    trees = [init_params(tiny_model_cfg, seed=s) for s in range(3)]
    save = tmp_path / "save"
    if form == "empty_dir":
        save.mkdir()
        with pytest.raises(FileNotFoundError, match="train_state"):
            cli.load_params(str(save), tiny_model_cfg)
        return
    if form == "reference_pth":
        path = str(tmp_path / "model.pth")
        save_reference_checkpoint(path, trees[0], tiny_model_cfg)
        want = trees[0]
    else:
        _save_state(str(save / "train_state"), trees[0], 2)
        newest = _save_state(str(save / "train_state"), trees[1], 4)
        want, path = trees[1], str(save)
        if form == "both_streams":
            _save_state(str(save / "train_state_best"), trees[2], 3)
            want = trees[2]
        elif form == "step_file":
            path = newest
    got = cli.load_params(path, tiny_model_cfg)
    flat = lambda t: torch.cat([x.reshape(-1).float() for x in tree_leaves(t)])  # noqa: E731
    assert torch.equal(flat(got), flat(want))
