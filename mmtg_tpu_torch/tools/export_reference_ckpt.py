"""Export a train state of the port to the reference's ``.pth`` format
(``scripts/export_reference_ckpt.py`` of the JAX package, which does the
same for an Orbax checkpoint).

A user who trained with ``python -m mmtg_tpu_torch.train`` can hand the
result back to the reference PyTorch code (its loader: reference
``generate.py:188-192``):

    python -m mmtg_tpu_torch.tools.export_reference_ckpt \\
        --ckpt RUN/train_state --out mmtg_ckpt.pth [--model_config_json gpt2.json]

``--ckpt`` is a directory of ``step_N.pt`` train states, as the trainer
writes them under its ``--save_path`` (``train_state/``, or
``train_state_best/`` for the best-val stream); the newest one is restored
through :func:`mmtg_tpu_torch.checkpoint.restore_train_state`. The file
written is ``{'model': module.-prefixed state dict, 'args': {},
'model_cfgs': {}}``, the shape reference ``train.py:212-213`` saves
(:func:`mmtg_tpu_torch.checkpoint.save_reference_checkpoint`). The export
computes nothing, so it runs on the CPU: the train state is built there and
the file's tensors are read into it.
"""

from __future__ import annotations

import argparse
import sys


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="a directory of step_N.pt train states (save_path/"
                        "train_state or save_path/train_state_best)")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--model_config_json", default="",
                   help="GPT-2 config JSON if the model was non-default")
    return p


def export(ckpt: str, out: str, mcfg) -> int:
    """Restore the newest train state of ``ckpt`` (on the CPU) and write its
    parameters to ``out`` in the reference's format. Returns its step;
    raises ``FileNotFoundError`` when ``ckpt`` holds none."""
    from mmtg_tpu_torch.checkpoint import restore_train_state, save_reference_checkpoint
    from mmtg_tpu_torch.configs import TrainConfig
    from mmtg_tpu_torch.train import create_train_state

    template, _ = create_train_state(0, mcfg, TrainConfig(), 1, 10, device="cpu")
    state, step = restore_train_state(ckpt, template)
    if step < 0:
        raise FileNotFoundError(f"no step_*.pt train state under {ckpt}")
    save_reference_checkpoint(out, state.params, mcfg)
    return step


def main(argv=None, mcfg=None) -> int:
    """``mcfg``: the model configuration (default: the repo's model, or
    ``--model_config_json``'s GPT-2)."""
    from mmtg_tpu_torch.configs import GPT2Config, ModelConfig

    args = build_arg_parser().parse_args(argv)
    if mcfg is None:
        mcfg = (ModelConfig(gpt2=GPT2Config.from_json_file(args.model_config_json))
                if args.model_config_json else ModelConfig())
    try:
        step = export(args.ckpt, args.out, mcfg)
    except FileNotFoundError as e:
        print(f"export_reference_ckpt: {e}", file=sys.stderr)
        return 1
    print(f"exported step-{step} params to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
