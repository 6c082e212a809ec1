"""Processes that start together build once: two processes call the CUDA
kernels' ``_build.build()`` (on stub sources) or ``native.build()`` at the
same time, with a stub compiler that logs each call and takes a second;
the compiler runs for one of them only, and both get the same library."""

import os
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB_COMPILER = """#!/bin/sh
echo "$*" >> {log}
sleep 1
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""

RUN = {
    "kernels": ("from mmtg_tpu_torch.kernels import _build as b\n"
                "b.CSRC_DIR, b.BUILD_DIR = sys.argv[1], sys.argv[2]\n"
                "b._nvcc = lambda: sys.argv[3]\n"
                "print(b.build())\n"),
    "native": ("from mmtg_tpu_torch import native as b\n"
               "b.BUILD_DIR = sys.argv[2]\n"
               "b.compiler = lambda: sys.argv[3]\n"
               "print(b.build('wordpiece'))\n"),
}
# compiler calls of one build: one a source and the link, or one g++
CALLS = {"kernels": 3, "native": 1}


@pytest.mark.parametrize("which", sorted(RUN))
def test_two_processes_build_once(tmp_path, which):
    src, build, log = tmp_path / "csrc", tmp_path / "build", tmp_path / "calls.log"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// stub source {name}\n")
    stub = tmp_path / "compiler.sh"
    stub.write_text(STUB_COMPILER.format(log=log))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PYTHONPATH=REPO)
    code = "import sys\n" + RUN[which]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src), str(build),
                               str(stub)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert len(log.read_text().splitlines()) == CALLS[which]
