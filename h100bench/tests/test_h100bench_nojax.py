"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names."""

import subprocess
import sys

from h100bench import harness


def test_whole_top_level_names(monkeypatch):
    fake = dict.fromkeys(["mmtg_tpu_torch", "mmtg_tpu_torch.ops", "jaxtyping",
                          "flaxen", "os"])
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.jax_modules() == []
    fake["mmtg_tpu.models"] = None
    fake["jaxlib.xla_client"] = None
    assert harness.jax_modules() == ["jaxlib", "mmtg_tpu"]


def test_harness_modules_load_no_jax():
    code = (
        "import sys; from h100bench import harness, run, control, trace, work;"
        "import h100bench.reference.model, h100bench.reference.train;"
        "[harness.driver(k) for k in ('generate', 'train')];"
        "man = harness.manifest();"
        "[harness.metric(m['name']) for m in man['per_layer']];"
        "import mmtg_tpu_torch.decoding, mmtg_tpu_torch.train;"
        "print(harness.jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, check=True)
    assert out.stdout.strip() == "[]"
