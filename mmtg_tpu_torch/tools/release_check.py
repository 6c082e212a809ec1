"""One-command release gate of the port (``tools/release_check.py`` of the JAX
package): everything that must be green before a tag.

Chains, in order, each in its own subprocess and process group:

  1. native   — build the C++ layer (the WordPiece tokenizer with its row
                packer, and the BPE encoder) through ``mmtg_tpu_torch.native``'s
                loaders, into ``build/native/``; fails without a C++ compiler
                (no silent Python fallback here)
  2. tests    — the port's CPU tests, ``tests/test_torch_*.py`` (``--tests
                fast`` runs a ~90-second subset; ``full`` all of them)
  3. dryrun   — a 2-rank gloo job on the CPU (``torchrun``): the multihost
                smoke's DP train step, then TP and pipeline steps, an eval
                step and ``generate_sharded`` at the tiny size, through the
                port's mesh code (``multihost_smoke --dryrun``)
  4. validate — ``chip_smoke.py --kernels-only`` (every CUDA kernel built and
                held against its plain version on the card), then
                ``tests/test_torch_kernels_cuda.py`` (skipped with ``--no-gpu``)
  5. bench    — a short ``bench_latency`` smoke on the card (skipped with
                ``--no-gpu``): the decode path end to end, NOT a number to
                quote

Steps run strictly one after another. A step past its time limit has its
whole process group killed, fails, and every later step is reported skipped.
Without a CUDA card and without ``--no-gpu`` the gate fails (it does not
skip the card's steps).

Usage:
  python -m mmtg_tpu_torch.tools.release_check                # full gate
  python -m mmtg_tpu_torch.tools.release_check --tests fast   # quick gate
  python -m mmtg_tpu_torch.tools.release_check --no-gpu       # host only

Exit code 0 only if every selected step passed; prints one PASS/FAIL line
per step plus a JSON summary line the caller can parse.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# a ~90-second subset for `--tests fast`: configs and data framing, the
# loss, the kernels' plain versions against JAX, the train step, the
# service, the import rule. Use `--tests full` before a tag.
FAST_TESTS = [
    "tests/test_torch_no_jax.py",
    "tests/test_torch_loss.py",
    "tests/test_torch_decode_attention.py",
    "tests/test_torch_fused_gru.py",
    "tests/test_torch_train_step.py",
    "tests/test_torch_serve.py",
]

NATIVE = ("import sys\n"
          "from mmtg_tpu_torch import native\n"
          "if native.compiler() is None:\n"
          "    sys.exit('native: no C++ compiler ($CXX, g++ or c++) found')\n"
          "for name in ('wordpiece', 'bpe'):\n"
          "    print(name, native.library_path(name), native.load(name) is not None)\n")


def _env() -> dict:
    # APPEND the repo to PYTHONPATH, keeping what the caller set
    pythonpath = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p)
    return dict(os.environ, PYTHONPATH=pythonpath)


def _run(name: str, cmd: list, timeout: float) -> dict:
    """Run one gate step in its own PROCESS GROUP.

    On timeout, SIGKILL the whole group — not just the direct child: pytest,
    torchrun and chip_smoke start children of their own, and a survivor
    would keep running (and keep the card busy) while the gate goes on."""
    print(f"=== {name}: {' '.join(cmd)} ===", flush=True)
    t0 = time.monotonic()
    timed_out = False
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(), start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        timed_out = True
        rc = -1
        print(f"=== TIMEOUT after {timeout:.0f}s: {name} — killing its "
              f"process group ===", flush=True)
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        proc.wait()
    dt = time.monotonic() - t0
    print(f"=== {'PASS' if rc == 0 else f'FAIL (rc={rc})'}: {name} "
          f"({dt:.1f}s) ===\n", flush=True)
    return {"step": name, "ok": rc == 0, "seconds": round(dt, 1),
            "timed_out": timed_out}


def _no_card(name: str) -> dict:
    """A card step's result where there is no card: a failure, not a skip."""
    print(f"=== FAIL: {name} — no CUDA device (torch.cuda.is_available() is "
          f"False); pass --no-gpu to leave the card's steps out ===\n", flush=True)
    return {"step": name, "ok": False, "seconds": 0.0, "timed_out": False,
            "no_gpu": True}


def steps(args) -> list:
    """``(name, command, time limit in s)`` of each selected step; a command
    of ``None`` is a card step on a host without a card."""
    py = sys.executable
    out = [("native", [py, "-c", NATIVE], 600.0)]
    if args.tests != "none":
        sel = (FAST_TESTS if args.tests == "fast"
               else sorted(os.path.relpath(p, ROOT) for p in glob.glob(
                   os.path.join(ROOT, "tests", "test_torch_*.py"))))
        out.append(("tests", [py, "-m", "pytest", *sel, "-q"], 3600.0))
    out.append(("dryrun", [py, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2", "-m",
                           "mmtg_tpu_torch.tools.multihost_smoke", "--device",
                           "cpu", "--dryrun"], 1800.0))
    if not args.no_gpu:
        import torch

        card = torch.cuda.is_available()
        out.append(("validate", [
            "bash", "-c",
            f"{py} chip_smoke.py --kernels-only && {py} -m pytest --noconftest "
            "-q tests/test_torch_kernels_cuda.py"] if card else None, 1800.0))
        out.append(("bench", [
            py, "-m", "mmtg_tpu_torch.tools.bench_latency", "--batches", "64",
            "--weight-dtypes", "model", "--runs", "3"] if card else None, 1800.0))
    return out


def run_steps(selected) -> list:
    """Each step in turn; after a timeout the rest are reported skipped."""
    results = []
    for i, (name, cmd, timeout) in enumerate(selected):
        results.append(_run(name, cmd, timeout) if cmd else _no_card(name))
        if results[-1]["timed_out"]:
            # A timed-out step means a killed process group; don't trust
            # the host state enough to keep going (least of all into card
            # steps whose numbers assume an idle host): fail the gate now
            # and report the remaining steps as skipped.
            results.extend({"step": n, "ok": False, "seconds": 0.0,
                            "skipped_after_timeout": True}
                           for n, _, _ in selected[i + 1:])
            break
    return results


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tests", choices=("full", "fast", "none"), default="full")
    ap.add_argument("--no-gpu", action="store_true",
                    help="leave out the card's steps (validate + bench)")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    results = run_steps(steps(args))
    ok = all(r["ok"] for r in results)
    print(json.dumps({"release_check": "PASS" if ok else "FAIL",
                      "steps": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
