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


# a small model for the run above: the tools' payloads draw topic ids up to
# 7999, so the vocabulary is 8192
_TINY = (
    "ModelConfig(seq_len=5, topic=ChannelConfig(input_dim=64, hidden_dim=32, "
    "type='MLP'), image=ChannelConfig(input_dim=64, hidden_dim=32), "
    "text=ChannelConfig(input_dim=64, hidden_dim=32), self_att_hidden_size=32, "
    "self_att_heads=4, mm_att_out_dim=64, gpt2=GPT2Config(vocab_size=8192, "
    "n_positions=256, n_ctx=250, n_embd=48, n_layer=2, n_head=4)), "
    "DataConfig(wenlan_emb_size=64, max_seq_length=22)")


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
                 "mmtg_tpu_torch.predict", "mmtg_tpu_torch.native",
                 "mmtg_tpu_torch.parallel", "mmtg_tpu_torch.parallel.mesh",
                 "mmtg_tpu_torch.parallel.pipeline",
                 "mmtg_tpu_torch.quality_loop",
                 "mmtg_tpu_torch.utils.roofline",
                 "mmtg_tpu_torch.tools", "mmtg_tpu_torch.tools.serve_common",
                 "mmtg_tpu_torch.tools.bench_serve",
                 "mmtg_tpu_torch.tools.bench_stream",
                 "mmtg_tpu_torch.tools.soak_serve",
                 "mmtg_tpu_torch.tools.bench_serve_http",
                 "mmtg_tpu_torch.tools.fixed_cost_sweep",
                 "mmtg_tpu_torch.tools.bench_latency",
                 "mmtg_tpu_torch.tools.trace_train",
                 "mmtg_tpu_torch.tools.trace_decode",
                 "mmtg_tpu_torch.tools.bench_pack",
                 "mmtg_tpu_torch.tools.multihost_smoke",
                 "mmtg_tpu_torch.tools.release_check",
                 "mmtg_tpu_torch.tools.make_fixtures",
                 "mmtg_tpu_torch.ops.matmul", "mmtg_tpu_torch.ops.cumsum",
                 "mmtg_tpu_torch.tools.batch_invariance",
                 "mmtg_tpu_torch.tools.export_reference_ckpt",
                 "mmtg_tpu_torch.tools.parity_check"):
        assert name in mods


def test_importing_the_port_never_imports_jax():
    """Every module imported, then a serving tool's ``run`` on the CPU at a
    tiny config: neither loads ``jax``, ``mmtg_tpu`` or the repo's tools/."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "from mmtg_tpu_torch.configs import *\n"
        "from mmtg_tpu_torch.tools import bench_serve\n"
        f"mcfg, dcfg = {_TINY}\n"
        "bench_serve.run(bench_serve.build_arg_parser().parse_args("
        "'--clients 2 --requests 2 --buckets 2 --solo-runs 1 --device cpu'"
        ".split()), mcfg, dcfg)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'mmtg_tpu', 'tools', 'serve_common'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


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
            "mmtg_tpu_torch/predict.py", "mmtg_tpu_torch/native.py",
            "mmtg_tpu_torch/parallel/mesh.py",
            "mmtg_tpu_torch/parallel/pipeline.py",
            "mmtg_tpu_torch/tools/serve_common.py",
            "mmtg_tpu_torch/tools/bench_serve.py",
            "mmtg_tpu_torch/tools/bench_stream.py",
            "mmtg_tpu_torch/tools/soak_serve.py",
            "mmtg_tpu_torch/tools/bench_serve_http.py",
            "mmtg_tpu_torch/tools/fixed_cost_sweep.py",
            "mmtg_tpu_torch/tools/bench_latency.py",
            "mmtg_tpu_torch/tools/trace_train.py",
            "mmtg_tpu_torch/tools/trace_decode.py",
            "mmtg_tpu_torch/tools/bench_pack.py",
            "mmtg_tpu_torch/tools/multihost_smoke.py",
            "mmtg_tpu_torch/tools/release_check.py",
            "mmtg_tpu_torch/tools/make_fixtures.py",
            "mmtg_tpu_torch/ops/matmul.py", "mmtg_tpu_torch/ops/cumsum.py",
            "mmtg_tpu_torch/tools/batch_invariance.py",
            "mmtg_tpu_torch/tools/export_reference_ckpt.py",
            "mmtg_tpu_torch/tools/parity_check.py"} <= names
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


# the JAX tools' own way to their helper: the repo's tools/ put on sys.path
_TOOLS_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:tools|serve_common)(?:[.\s]|$)|sys\.path", re.M)


def test_the_port_tools_do_not_reach_the_repo_tools():
    """mmtg_tpu_torch/tools/ imports its helpers from the port's package,
    never the repo's tools/ (by name or through sys.path)."""
    files = glob.glob(os.path.join(REPO, "mmtg_tpu_torch", "tools", "*.py"))
    assert len(files) == 18
    for path in files:
        with open(path, encoding="utf-8") as f:
            found = _TOOLS_IMPORT.findall(f.read())
        assert not found, f"{os.path.relpath(path, REPO)}: {found}"
    for line in ("from serve_common import build_model", "import tools.bench_serve",
                 "sys.path.insert(0, here)"):
        assert _TOOLS_IMPORT.search(line), line
    assert not _TOOLS_IMPORT.search(
        "from mmtg_tpu_torch.tools.serve_common import build_model")


# a module of the JAX package named on a command line (``-m mmtg_tpu.train``,
# ``mmtg_tpu/...``) or its scripts (``scripts/make_fixtures.py``)
_JAX_MODULE = re.compile(r"\bmmtg_tpu(?:\.|/)|scripts/(?:make_fixtures|train)\.(?:py|sh)\b")


def test_the_port_launchers_run_only_the_port():
    """scripts/train_torch.sh and generate_torch.sh run the port's CLIs and
    fixture tool, never a module or script of the JAX package."""
    for name, wants in (("train_torch.sh", ("-m mmtg_tpu_torch.train",
                                            "-m mmtg_tpu_torch.tools.make_fixtures")),
                        ("generate_torch.sh", ("-m mmtg_tpu_torch.generate",
                                               "-m mmtg_tpu_torch.tools.make_fixtures",
                                               "bash scripts/train_torch.sh"))):
        with open(os.path.join(REPO, "scripts", name), encoding="utf-8") as f:
            text = f.read()
        assert not _JAX_MODULE.findall(text), f"{name}: {_JAX_MODULE.findall(text)}"
        for want in wants:
            assert want in text, f"{name} does not run {want}"
    for line in ("python -m mmtg_tpu.generate", "python scripts/make_fixtures.py",
                 "bash scripts/train.sh", "import mmtg_tpu/x"):
        assert _JAX_MODULE.search(line), line
    assert not _JAX_MODULE.search("python -m mmtg_tpu_torch.train")
