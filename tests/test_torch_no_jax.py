"""The port runs where JAX is not installed and stands apart from the JAX
package: importing any of its modules (or chip_smoke) imports neither
``jax`` nor anything of ``mmtg_tpu``, and no source of it has such an import
statement."""

import glob
import os
import pkgutil
import re
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
                 "mmtg_tpu_torch.kernels._build",
                 "mmtg_tpu_torch.train", "mmtg_tpu_torch.loss",
                 "mmtg_tpu_torch.configs", "mmtg_tpu_torch.data",
                 "mmtg_tpu_torch.bpe", "mmtg_tpu_torch.tokenizer",
                 "mmtg_tpu_torch.utils.logging",
                 "mmtg_tpu_torch.ops.train_attention",
                 "mmtg_tpu_torch.pack", "mmtg_tpu_torch.eval",
                 "mmtg_tpu_torch.pretrain", "mmtg_tpu_torch.serve",
                 "mmtg_tpu_torch.ops.prng", "mmtg_tpu_torch.ops.sampling",
                 "mmtg_tpu_torch.ops.decode_megakernel",
                 "mmtg_tpu_torch.predict", "mmtg_tpu_torch.native"):
        assert name in mods


def test_importing_the_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'mmtg_tpu' or k.startswith('mmtg_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|mmtg_tpu)(?:[.\s]|$)", re.M)


def _sources():
    pkg = os.path.join(REPO, "mmtg_tpu_torch")
    return sorted(glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)) + [
        os.path.join(REPO, "chip_smoke.py")]


def test_no_source_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"mmtg_tpu_torch/pack.py", "mmtg_tpu_torch/eval.py",
            "mmtg_tpu_torch/pretrain.py", "mmtg_tpu_torch/ops/train_attention.py",
            "mmtg_tpu_torch/kernels/_build.py", "chip_smoke.py",
            "mmtg_tpu_torch/serve.py", "mmtg_tpu_torch/ops/prng.py",
            "mmtg_tpu_torch/ops/decode_megakernel.py",
            "mmtg_tpu_torch/predict.py", "mmtg_tpu_torch/native.py"} <= names
    for path in files:
        with open(path, encoding="utf-8") as f:
            found = _IMPORT.findall(f.read())
        assert not found, f"{os.path.relpath(path, REPO)} imports {found}"


def test_the_import_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "  import mmtg_tpu",
                 "from mmtg_tpu.configs import ModelConfig", "import mmtg_tpu.data"):
        assert _IMPORT.search(line), line
    for line in ("from mmtg_tpu_torch.configs import ModelConfig",
                 "import mmtg_tpu_torch", "# from mmtg_tpu import x in a comment",
                 ":mod:`mmtg_tpu.decoding`"):
        assert not _IMPORT.search(line), line
