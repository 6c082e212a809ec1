"""``python -m mmtg_tpu_torch.tools.multihost_smoke`` with dropout off and
the parameters of the torch-saved tree named by ``$MMTG_SMOKE_PARAMS`` (the
tool's own start is the seeded init, dropout on); rank 0 writes the loss of
every train step the smoke and its ``--dryrun`` take, at full precision, to
``$MMTG_SMOKE_OUT`` as JSON. ``tests/test_torch_release_tools.py`` launches it
under ``torchrun``."""

import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import params as tparams  # noqa: E402
from mmtg_tpu_torch.tools import multihost_smoke as smoke  # noqa: E402


def no_dropout():
    mcfg, dcfg, tcfg = real_configs()
    return dataclasses.replace(mcfg, gpt2=dataclasses.replace(
        mcfg.gpt2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)), dcfg, tcfg


def step(*a, **k):
    state, m = real_step(*a, **k)
    losses.append(float(m["total"]))
    return state, m


if __name__ == "__main__":
    torch.set_num_threads(1)
    losses = []
    real_configs, real_step = smoke.tiny_configs, smoke._step
    smoke.tiny_configs, smoke._step = no_dropout, step
    tparams.init_params = lambda mcfg, seed=0: torch.load(
        os.environ["MMTG_SMOKE_PARAMS"], weights_only=False)
    rank = os.environ["RANK"]
    smoke.main(sys.argv[1:])
    if rank == "0":
        with open(os.environ["MMTG_SMOKE_OUT"], "w") as f:
            json.dump(losses, f)
