"""Logging / timing utilities (the port's own copy of
:mod:`mmtg_tpu.utils.logging`).

Keeps the reference's observability surface (CLI-selected log file with
step/val logs — ``train.py:58-63``, ``utils.py:13-20``) and adds per-step
wall-time and samples/sec counters. :class:`StepTimer` waits for the CUDA
device before it reads the clock, so a step's time includes its kernels.
:func:`maybe_profile` is the ``torch.profiler`` trace hook.

:func:`span` marks a stretch of the program's own work by name (``decode.step``,
``train.backward``, ...). Recording is off until :func:`record_spans` turns it
on; off, a span is one flag test and a shared no-op context. A span reads the
host clock alone: it never waits for the card, reads nothing back from it and
adds nothing to a profiler's trace while it runs. Its stamps are
``time.time_ns()``, the clock ``torch.profiler`` writes its events on (a
Chrome trace's ``ts`` + ``baseTimeNanoseconds`` / 1000), so
:func:`chrome_span_events` puts spans on the device trace's timeline.
"""

from __future__ import annotations

import array
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import List, NamedTuple, Optional

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


class Span(NamedTuple):
    """One recorded span: host-clock stamps in ns (``time.time_ns()``), its
    id, its parent's (0 at the top), the OS id of the thread that ran it,
    and its call's id (the id of the top span it sits under: every span of
    one ``generate`` call or one train step shares it)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    thread: int
    call: int


class _Recorder:
    """The process's span recorder: the on flag, the finished spans, and
    each thread's stack of open ones and OS id.

    A finished span is kept as its name and six integers (:class:`Span`'s
    other fields, in order) in a flat array, under a lock that keeps the
    two in step across threads: nothing the garbage collector tracks is
    left behind while recording. 862 ``Span`` tuples a
    ``generate`` call set off a young-generation collection in the call,
    which under ``torch.profiler`` took 0.25-0.59 s on an H100 host."""

    def __init__(self):
        self.on = False
        self.names: List[str] = []
        self.fields = array.array("q")
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def spans(self, first: int = 0) -> List[Span]:
        """The finished spans from the ``first``-th on."""
        f = self.fields
        return [Span(n, *f[6 * i:6 * i + 6])
                for i, n in enumerate(self.names[first:], first)]

    def thread(self) -> tuple:
        """(this thread's stack of open spans, its OS id). The id is read
        once a thread: reading it is a system call (7.5 µs on an
        H100 host, where reading it at every span slowed a 2048-row
        ``generate`` call by 7%)."""
        t = getattr(self.local, "t", None)
        if t is None:
            t = self.local.t = ([], threading.get_native_id())
        return t


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Open:
    """An open span: what :func:`span` returns while recording is on."""

    __slots__ = ("name", "start", "id", "parent", "call", "thread")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st, self.thread = _REC.thread()
        top = st[-1] if st else None
        self.id = next(_REC.ids)
        self.parent = top.id if top else 0
        self.call = top.call if top else self.id
        st.append(self)
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        _REC.thread()[0].pop()
        with _REC.lock:
            _REC.names.append(self.name)
            _REC.fields.extend((self.start, end, self.id, self.parent,
                                self.thread, self.call))
        return False


def span(name: str):
    """A context that records ``name`` over the enclosed work while
    :func:`record_spans` is on (and does nothing otherwise)."""
    if not _REC.on:
        return _OFF
    return _Open(name)


@contextlib.contextmanager
def record_spans():
    """Record spans over the block; yields a list that holds, once the block
    has ended, the spans finished inside it. Blocks nest: an inner block's
    spans are an outer one's too."""
    was_on, first = _REC.on, len(_REC.names)
    got: List[Span] = []
    _REC.on = True
    try:
        yield got
    finally:
        _REC.on = was_on
        with _REC.lock:
            got.extend(_REC.spans(first))
            if not was_on:
                _REC.names.clear()
                del _REC.fields[:]


SPAN_CAT = "program_span"
SPAN_TID = 1 << 30  # above any OS thread id: the spans' rows are their own


def chrome_span_events(spans: List[Span], base_ns: int = 0) -> List[dict]:
    """``spans`` as Chrome-trace events on a trace whose ``ts`` are µs after
    ``base_ns`` (its ``baseTimeNanoseconds``): one row, "program spans", per
    thread that ran spans, in the process of the trace's host events."""
    pid = os.getpid()
    rows = {t: SPAN_TID + i for i, t in enumerate(sorted({s.thread for s in spans}))}
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"program spans (thread {t})"}}
           for t, tid in rows.items()]
    for s in spans:
        out.append({"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid,
                    "tid": rows[s.thread], "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "call": s.call,
                             "thread": s.thread}})
    return out


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], host_ops: bool = True):
    """``torch.profiler`` trace of the enclosed work (host ops, and the CUDA
    kernels when a card is present), written on exit as a Chrome / Perfetto
    trace ``<trace_dir>/trace_<pid>_<ns>.json``, with the program's spans
    recorded over the work as their own rows (:func:`chrome_span_events`);
    a no-op for an empty ``trace_dir``. ``host_ops=False`` with a card
    records the GPU timeline (and the runtime calls) alone: recording every
    host operator slows a host-bound loop's dispatch several times over,
    which would stretch the very wall the device's busy share is read
    against."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if host_ops or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof, record_spans() as spans:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the kernels of the traced work
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if not spans:
        return
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(chrome_span_events(
        spans, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path + ".tmp", "w") as f:
        json.dump(trace, f)
    os.replace(path + ".tmp", path)  # a failed write leaves the profiler's trace
