"""``python -m mmtg_tpu_torch.serve`` on a small model: the CLI's ``main``
with the model and data configs of the torch-saved ``(mcfg, dcfg)`` named by
``$MMTG_SERVE_CONFIGS`` (the CLI's own default is the 12-layer model).
``tests/test_torch_serve_mesh.py`` launches it under ``torchrun``."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import serve  # noqa: E402

if __name__ == "__main__":
    mcfg, dcfg = torch.load(os.environ["MMTG_SERVE_CONFIGS"], weights_only=False)
    serve.main(sys.argv[1:], mcfg=mcfg, dcfg=dcfg)
