"""Logging / timing utilities (the port's own copy of
:mod:`mmtg_tpu.utils.logging`).

Keeps the reference's observability surface (CLI-selected log file with
step/val logs — ``train.py:58-63``, ``utils.py:13-20``) and adds per-step
wall-time and samples/sec counters. :class:`StepTimer` waits for the CUDA
device before it reads the clock, so a step's time includes its kernels.
:func:`maybe_profile` is the ``torch.profiler`` trace hook.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch


def format_time(elapsed: float) -> str:
    """hh:mm:ss (reference ``utils.py:13-20``)."""
    elapsed_rounded = int(round(elapsed))
    h = elapsed_rounded // 3600
    m = (elapsed_rounded % 3600) // 60
    s = elapsed_rounded % 60
    return f"{h:02d}:{m:02d}:{s:02d}"


def setup_logger(log_path: Optional[str] = None, name: str = "mmtg_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)-2s - %(filename)-8s : "
        "%(lineno)s line - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if log_path:
        import os

        parent = os.path.dirname(log_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # a later run in the same process logging to the same path (after
        # the file was removed, say) gets one handler on the new file, not
        # a second one that would duplicate every line
        for h in list(logger.handlers):
            if (isinstance(h, logging.FileHandler)
                    and h.baseFilename == os.path.abspath(log_path)):
                logger.removeHandler(h)
                h.close()
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


class StepTimer:
    """Rolling throughput counter (samples/sec, tokens/sec, p50 step ms)."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def p50_ms(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return 1000.0 * s[len(s) // 2]

    def throughput(self, units_per_step: int) -> float:
        if not self.times:
            return 0.0
        avg = sum(self.times) / len(self.times)
        return units_per_step / avg


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], host_ops: bool = True):
    """``torch.profiler`` trace of the enclosed work (host ops, and the CUDA
    kernels when a card is present), written on exit as a Chrome / Perfetto
    trace ``<trace_dir>/trace_<pid>_<ns>.json``; a no-op for an empty
    ``trace_dir``. ``host_ops=False`` with a card records the GPU timeline
    (and the runtime calls) alone: recording every host operator slows a
    host-bound loop's dispatch several times over, which would stretch the
    very wall the device's busy share is read against."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if host_ops or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the kernels of the traced work
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
