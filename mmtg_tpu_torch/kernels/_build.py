"""Build and load the port's hand-written CUDA kernels.

Every ``mmtg_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process (all started together; ``*.cuh`` headers are shared between them) and the objects are linked into ONE shared
library with a plain C interface, ``build/kernels/libmmtg_kernels_<hash>.so``
under the repository root (``build/`` is git-ignored), loaded with
``ctypes``. The hash covers the sources and the flags, so an edited source
builds anew and an unchanged one is reused. Nothing is built at import:
:func:`load` runs on the first kernel launch, and only on a machine with the
CUDA toolkit.

Processes that start together (the ranks of a ``torchrun`` job) build once:
:func:`build` holds an exclusive ``fcntl.flock`` on ``build/kernels/.lock``
while it checks for the library and compiles, so the first process runs the
compilers and the others wait, then find the library. The lock goes with the
process that holds it, so a killed build leaves nothing to clean up.

Flags: ``sm_90a`` (Hopper), ``-O3``, and deliberately NO
``--use_fast_math`` — it makes ``/`` approximate, and the int8 cache writes
must stay bit-identical to the plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the .log
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the mmtg_tpu_torch CUDA kernels are built on a "
        "machine with the CUDA toolkit (CPU tensors use the plain versions)"
    )


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for src in sources() + headers:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libmmtg_kernels_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def build_lock(directory: str):
    """An exclusive lock on ``directory`` across processes (``flock`` on
    ``directory/.lock``, released when the block ends or the process dies)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> str:
    """Compile the sources if their library is not built yet; returns its
    path. The ptxas report goes to ``<library>.log``. One process at a time
    (:func:`build_lock`): the others wait and reuse its library."""
    out = library_path()
    if os.path.exists(out):
        return out
    with build_lock(BUILD_DIR):
        if not os.path.exists(out):  # built while this process waited
            _compile(out)
    return out


def _compile(out: str) -> None:
    nvcc = _nvcc()
    tmp = f"{out}.tmp{os.getpid()}"
    objs, procs = [], []
    for src in sources():  # one compiler per source, all at once
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    log, failed = "", []
    for src, proc in zip(sources(), procs):
        stdout, stderr = proc.communicate()
        log += f"== {os.path.basename(src)}\n{stdout}{stderr}"
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out + ".log", "w") as f:
        f.write(log + link.stdout + link.stderr)
    os.replace(tmp, out)  # atomic: a reader sees all or nothing


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mmtg_decode_attention.argtypes = (
        [p] * 11 + [i] * 6 + [f] + [i] * 7 + [p]
    )
    lib.mmtg_decode_attention.restype = i
    lib.mmtg_decode_block_fused.argtypes = (
        [p] * 12 + [i] * 6 + [f, f, i, p]
    )
    lib.mmtg_decode_block_fused.restype = i
    ll = ctypes.c_longlong
    lib.mmtg_matmul.argtypes = [p] * 5 + [i] * 5 + [ll] * 3 + [i] * 8 + [p]
    lib.mmtg_matmul.restype = i
    lib.mmtg_row_cumsum.argtypes = [p, p, i, i, i, p]
    lib.mmtg_row_cumsum.restype = i
    lib.mmtg_layer_norm.argtypes = [p] * 4 + [i, i, f, i, p]
    lib.mmtg_layer_norm.restype = i
    lib.mmtg_add_layer_norm.argtypes = [p] * 7 + [i, i, f, i, p]
    lib.mmtg_add_layer_norm.restype = i
    lib.mmtg_fused_gru.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.mmtg_fused_gru.restype = i
    lib.mmtg_mha_train_fwd.argtypes = (
        [p] * 6 + [i] * 6 + [f, f, u, i, i, p])
    lib.mmtg_mha_train_fwd.restype = i
    lib.mmtg_mha_train_bwd.argtypes = (
        [p] * 10 + [i] * 6 + [f, f, u, i, i, p])
    lib.mmtg_mha_train_bwd.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
