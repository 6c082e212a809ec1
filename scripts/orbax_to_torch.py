"""Convert a JAX run's Orbax checkpoints into the PyTorch port's files.

A JAX trainer's train states (``<save_path>/orbax/`` and
``<save_path>/orbax_best/``: parameters, AdamW moments and count, step,
PRNG key) become the port's ``<out>/train_state/step_N.pt`` and
``<out>/train_state_best/step_N.pt`` (the newest step of each), which
``python -m mmtg_tpu_torch.train --resume --save_path <out>``, the port's
``generate`` and ``serve`` read::

    python scripts/orbax_to_torch.py --save_path RUN [--out RUN]

A JAX ``pretrain.py`` directory (an Orbax ``{"gpt2": params}``) becomes the
``pytorch_model.bin`` that the port's own ``pretrain.py`` writes, which the
port's ``train --gpt2_ckpt DIR`` reads::

    python scripts/orbax_to_torch.py --pretrain DIR [--out DIR]

The model's shape comes from the flags the JAX run took
(``--model_config_json``, or ``--variant english --clip_dim N --vocab_path
DIR``). The JAX PRNG key has no counterpart in the port: the converted
state's dropout generator is seeded from ``--seed`` as the port's trainer
seeds a fresh one. This script needs JAX and Orbax; the port needs neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

STREAMS = (("orbax", "train_state"), ("orbax_best", "train_state_best"))


def _restore(src, template):
    """The newest Orbax step under ``src``, restored into ``template``."""
    from mmtg_tpu.checkpoint import restore_train_state

    state, at = restore_train_state(src, template)
    if at < 0:
        raise FileNotFoundError(f"no Orbax checkpoint under {src}")
    return state


def convert_train_state(src: str, out_dir: str, mcfg, seed: int = 42) -> str:
    """The newest Orbax train state under ``src`` → the port's
    ``<out_dir>/step_N.pt``; ``mcfg`` is the JAX package's model config.
    Returns the file's path."""
    import jax
    import torch

    from mmtg_tpu.configs import TrainConfig
    from mmtg_tpu.train import create_train_state
    from mmtg_tpu_torch import params as tparams
    from mmtg_tpu_torch.checkpoint import save_train_state
    from mmtg_tpu_torch.train import TrainState

    # the optimizer's tree (clip, (adam, decayed weights, schedule)) does not
    # depend on the rates, so the default TrainConfig builds the template
    template, _ = create_train_state(jax.random.PRNGKey(0), mcfg, TrainConfig(), 1, 2)
    state = jax.device_get(_restore(src, template))
    _, (adam, _, schedule) = state.opt_state
    if int(schedule.count) != int(adam.count):
        raise ValueError(f"{src}: the schedule's count {int(schedule.count)} is "
                         f"not AdamW's {int(adam.count)} (the port keeps one)")
    port_state = TrainState(
        params=tparams.from_jax_numpy(state.params, dtype=torch.float32),
        opt_state=tparams.adam_state_from_numpy(adam.mu, adam.nu, adam.count),
        step=int(state.step),
        rng=torch.Generator().manual_seed(seed + 1))
    return save_train_state(out_dir, int(state.step), port_state)


def convert_pretrain(src: str, out_dir: str, gpt2_cfg) -> str:
    """A JAX ``pretrain.py`` Orbax directory → ``<out_dir>/pytorch_model.bin``
    (a Hugging Face ``GPT2LMHeadModel`` state dict, as the port's
    ``pretrain.py`` writes it); ``gpt2_cfg`` is the JAX package's GPT-2
    config. Returns the file's path."""
    import jax
    import torch

    from mmtg_tpu.models.gpt2 import init_gpt2_params
    from mmtg_tpu_torch import params as tparams
    from mmtg_tpu_torch.configs import GPT2Config
    from mmtg_tpu_torch.models.gpt2 import export_hf_gpt2

    template = {"gpt2": init_gpt2_params(jax.random.PRNGKey(0), gpt2_cfg)}
    restored = _restore(src, template)
    gpt2 = tparams.from_jax_numpy(jax.device_get(restored["gpt2"]), dtype=torch.float32)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pytorch_model.bin")
    torch.save(export_hf_gpt2(gpt2, GPT2Config(**dataclasses.asdict(gpt2_cfg))), path)
    return path


def model_config(args):
    """The JAX package's model config from the JAX trainer's flags."""
    from mmtg_tpu.configs import GPT2Config, ModelConfig, english_variant

    if args.variant == "english":
        from mmtg_tpu.bpe import load_tokenizer

        return english_variant(clip_dim=args.clip_dim,
                               gpt2_vocab=len(load_tokenizer(args.vocab_path)))[0]
    if args.model_config_json:
        return ModelConfig(gpt2=GPT2Config.from_json_file(args.model_config_json))
    return ModelConfig()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert a JAX run's Orbax train states (or a JAX "
                    "pretrain directory) into the PyTorch port's files.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--save_path", default="",
                     help="a JAX trainer's --save_path: its orbax/ and "
                          "orbax_best/ become train_state/ and "
                          "train_state_best/ under --out")
    src.add_argument("--pretrain", default="",
                     help="a JAX pretrain.py --save_path: becomes "
                          "<out>/pytorch_model.bin for the port's --gpt2_ckpt")
    p.add_argument("--out", default="",
                   help="output directory (default: the source directory)")
    p.add_argument("--seed", default=42, type=int,
                   help="the JAX PRNG key has no counterpart: the port's "
                        "dropout generator is seeded from this seed, as its "
                        "trainer seeds a fresh state")
    p.add_argument("--model_config_json", default="",
                   help="GPT-2 config JSON the JAX run took, if any")
    p.add_argument("--variant", default="chinese", choices=["chinese", "english"])
    p.add_argument("--clip_dim", default=512, type=int)
    p.add_argument("--vocab_path", default="./vocab/vocab.txt",
                   help="--variant english: the vocab.json + merges.txt directory")
    return p


def main(argv=None, mcfg=None) -> int:
    """CLI entry; ``mcfg`` (the JAX package's model config) replaces the one
    the flags name."""
    args = build_arg_parser().parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    mcfg = mcfg or model_config(args)
    if args.pretrain:
        path = convert_pretrain(args.pretrain, args.out or args.pretrain, mcfg.gpt2)
        print(f"wrote {path}")
        return 0
    out = args.out or args.save_path
    done = 0
    for orbax_sub, port_sub in STREAMS:
        src = os.path.join(args.save_path, orbax_sub)
        if os.path.isdir(src):
            path = convert_train_state(src, os.path.join(out, port_sub), mcfg,
                                       args.seed)
            print(f"wrote {path}")
            done += 1
    if not done:
        raise SystemExit(f"no orbax/ or orbax_best/ under {args.save_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
