"""The port runs where JAX is not installed: importing any of its modules
must not import jax."""

import os
import pkgutil
import subprocess
import sys

import mmtg_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["mmtg_tpu_torch"]
    for info in pkgutil.walk_packages(mmtg_tpu_torch.__path__, "mmtg_tpu_torch."):
        names.append(info.name)
    return names


def test_module_list_covers_the_package():
    mods = set(_modules())
    for name in ("mmtg_tpu_torch.decoding", "mmtg_tpu_torch.generate",
                 "mmtg_tpu_torch.checkpoint", "mmtg_tpu_torch.params",
                 "mmtg_tpu_torch.models.gpt2", "mmtg_tpu_torch.ops.fused_gru",
                 "mmtg_tpu_torch.ops.decode_attention",
                 "mmtg_tpu_torch.kernels._build"):
        assert name in mods


def test_importing_the_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules "
        "if k.startswith('jax'))\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
