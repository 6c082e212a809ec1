"""Serving layer (:mod:`mmtg_tpu.serve`) over the PyTorch engine: a
window-batching generation service and its HTTP front, on one device.

The service collects concurrent generation requests into padded batches of
fixed sizes and decodes each batch through
:func:`mmtg_tpu_torch.decoding.generate`.

* **Window batching.** Requests that arrive while a window decodes queue for
  the next one. A batcher thread forms and decodes windows; a collector
  thread brings results to the host, resolves futures and feeds stream
  subscribers, so window N+1 is packed while window N's results are
  delivered.
* **Fixed batch buckets.** Each window is padded up to the smallest
  configured bucket, so the service runs a known set of shapes.
* **Per-request PRNG streams** (``decoding.generate(row_seeds=...)``, the
  threefry streams of :mod:`mmtg_tpu_torch.ops.prng`): a request's tokens
  depend only on ``(service base seed, request seed)`` — NOT on which other
  requests share its batch — so the batcher groups requests freely, and a
  client can replay any response.
* **Streaming rides the window batcher** (``POST /generate_stream`` →
  Server-Sent Events): a streamed request is packed into an ordinary window
  next to one-shot requests. A window that carries a streamer decodes
  through :func:`~mmtg_tpu_torch.decoding.generate_stream`; every block goes
  to the collector as soon as it is decoded and from there to its
  subscribers, sentence by sentence, while one-shot batch-mates get the
  assembled result at the end. A streamed response is TOKEN-IDENTICAL to the
  batched one for the same (sample, seed).

* **Meshed serving** (``mesh=``, or ``--mesh_data`` / ``--mesh_model``
  under ``torchrun``): windows decode data x tensor-parallel through
  :func:`~mmtg_tpu_torch.decoding.generate_sharded` /
  :func:`~mmtg_tpu_torch.decoding.generate_stream_sharded`. Rank 0 runs the
  service and the HTTP front; every other rank runs :func:`serve_follower`,
  which receives each window's operation, batch, seeds and chunk by
  ``broadcast`` from rank 0's batcher thread and makes the same call in
  step. ``/reload`` reaches the followers the same way, before the next
  window; :meth:`GenerationService.stop` ends them. Per-request streams
  make every response the single-device one, token for token.

Unlike the JAX service, whose dispatch returns before the device has
finished, the PyTorch decode is a host loop: the batcher thread is busy for
the length of a decode, and the overlap between windows is the delivery only.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import threading
import time
import zipfile
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mmtg_tpu_torch import decoding
from mmtg_tpu_torch.configs import (DataConfig, GenerateConfig, ModelConfig,
                                    SpecialTokens)
from mmtg_tpu_torch.ops import prng
from mmtg_tpu_torch.params import tree_leaves, tree_map
from mmtg_tpu_torch.parallel import mesh as pmesh

# the reference-keyed per-sample arrays a request must carry
SAMPLE_KEYS = (
    "topic_ids",
    "tpw_attention_mask",
    "tpw_type_ids",
    "topic_emb",
    "img_embs",
    "r_embs",
)
_FLOAT_KEYS = ("topic_emb", "img_embs", "r_embs")

# Binary request format for POST /generate: a standard ``.npz`` archive
# (Content-Type: application/x-npz, or auto-detected by the zip magic): the
# float embeddings of a sample as a zero-copy read instead of a JSON float
# parse. The response stays JSON (tokens are ~220 ints).
NPZ_CONTENT_TYPE = "application/x-npz"
_ZIP_MAGIC = b"PK\x03\x04"
# npz scalar sidecar keys (everything else must be a SAMPLE_KEYS array)
_NPZ_META_KEYS = ("seed", "timeout", "text")


def encode_request_npz(sample: Dict[str, np.ndarray], seed: int = 0,
                       timeout: Optional[float] = None,
                       text: Optional[bool] = None) -> bytes:
    """Client-side encoder for the binary /generate request body: the six
    SAMPLE_KEYS arrays plus optional scalar entries ``seed`` / ``timeout`` /
    ``text``, as an uncompressed ``savez``."""
    arrays = {k: np.asarray(sample[k]) for k in sample}
    arrays["seed"] = np.int64(seed)
    if timeout is not None:
        arrays["timeout"] = np.float64(timeout)
    if text is not None:
        arrays["text"] = np.bool_(text)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_request_npz(body: bytes) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Server-side decoder: returns ``(sample, meta)`` where meta carries the
    defaults of the JSON path (seed 0, timeout 600, text True).
    ``allow_pickle`` stays False: object arrays from an untrusted client must
    not deserialize."""
    with np.load(io.BytesIO(body)) as z:
        sample = {k: z[k] for k in z.files if k not in _NPZ_META_KEYS}
        meta = {
            "seed": int(z["seed"]) if "seed" in z.files else 0,
            "timeout": float(z["timeout"]) if "timeout" in z.files else 600.0,
            "text": bool(z["text"]) if "text" in z.files else True,
        }
    return sample, meta


class ServiceOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at max_queue_depth —
    shed load at the edge (HTTP 503) instead of growing an unbounded
    host-side backlog."""


@dataclass
class _Pending:
    sample: Dict[str, np.ndarray]
    seed: int
    future: Future
    t_submit: float = field(default_factory=time.monotonic)
    # streaming subscribers: a queue the collector feeds decoded blocks
    # ([n] int32 rows), then a ``None`` done-sentinel (or an exception).
    # ``None`` here = an ordinary one-shot request.
    blocks: Optional["queue.Queue"] = None


def _to_host(x) -> np.ndarray:
    """A decoded value on the host; for a CUDA tensor this waits until the
    device has produced it."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# what rank 0's batcher tells the followers, first word of each broadcast
# header [op, bucket, chunk]
_OP_STOP, _OP_DECODE, _OP_STREAM, _OP_RELOAD = range(4)


def _service_gcfg(gcfg: GenerateConfig, buckets: Sequence[int],
                  meshed: bool) -> GenerateConfig:
    """``auto`` precisions resolved ONCE from the LARGEST bucket: every
    bucket must share one weight AND cache precision or the same (request,
    seed) would decode differently by the bucket its window landed in —
    breaking batch-composition invariance. A meshed service's cache resolves
    to the model dtype (``decoding.resolve_cache_dtype(sharded=True)``)."""
    if "auto" not in (gcfg.weight_dtype, gcfg.cache_dtype):
        return gcfg
    return dataclasses.replace(
        gcfg,
        weight_dtype=decoding.resolve_weight_dtype(gcfg, max(buckets)),
        cache_dtype=decoding.resolve_cache_dtype(gcfg, max(buckets),
                                                 sharded=meshed),
    )


def _expected_shapes(mcfg: ModelConfig, dcfg: DataConfig) -> Dict[str, tuple]:
    P, m = dcfg.topic_prompt_length, mcfg
    return {
        "topic_ids": (P,),
        "tpw_attention_mask": (P,),
        "tpw_type_ids": (P,),
        "topic_emb": (m.topic.input_dim,),
        "img_embs": (m.seq_len, m.image.input_dim),
        "r_embs": (m.seq_len, m.text.input_dim),
    }


def _window_buffers(mcfg, dcfg, bucket: int, ftype, device):
    """Empty tensors of a packed window of ``bucket`` rows (what
    :meth:`GenerationService._pack` makes), for a follower to receive into."""
    batch = {k: torch.empty((bucket,) + shape,
                            dtype=ftype if k in _FLOAT_KEYS else torch.int32,
                            device=device)
             for k, shape in _expected_shapes(mcfg, dcfg).items()}
    return batch, torch.empty(bucket, dtype=torch.int32, device=device)


def _broadcast_window(batch, seeds) -> None:
    for k in SAMPLE_KEYS:
        torch.distributed.broadcast(batch[k], src=0)
    torch.distributed.broadcast(seeds, src=0)


def _broadcast_tree(tree) -> None:
    for leaf in tree_leaves(tree):
        torch.distributed.broadcast(leaf, src=0)


class _MeshedParams:
    """What every rank of a meshed service keeps of the weights: its TP
    shard (the decode reads nothing else) and the full tree's shapes and
    dtypes (on the ``meta`` device), which ``/reload`` checks and receives
    into."""

    def __init__(self, params, mcfg: ModelConfig, mesh):
        self.mcfg, self.mesh = mcfg, mesh
        self.template = tree_map(lambda x: torch.empty_like(x, device="meta"),
                                 params)
        self.local = self.shard(params)

    def shard(self, params):
        """This rank's TP shard of a full tree."""
        g = self.mcfg.gpt2
        return pmesh.shard_decode_params(params, self.mesh, g.n_head, g.head_dim)

    def receive(self, device) -> None:
        """Take the full tree rank 0 broadcasts, keep this rank's shard."""
        full = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), self.template)
        _broadcast_tree(full)
        self.local = self.shard(full)


def serve_follower(params, const, mcfg: ModelConfig, dcfg: DataConfig,
                   gcfg: GenerateConfig, mesh, buckets: Sequence[int],
                   base_seed: int = 0) -> int:
    """The loop of a meshed service's rank other than 0: receive each
    window rank 0 decodes and make the same sharded call with it, until rank
    0 stops. Takes what the service on rank 0 was given (the same
    ``buckets`` and ``base_seed``, so ``auto`` resolves alike); returns the
    number of windows decoded. A failed call raises here as on rank 0."""
    if torch.distributed.get_rank() == 0:
        raise RuntimeError("serve_follower runs on the ranks other than 0; "
                           "rank 0 runs GenerationService(mesh=...)")
    device = const["wenlan_table"].device
    gcfg = _service_gcfg(gcfg, buckets, meshed=True)
    rng = prng.PRNGKey(base_seed, device=device)
    weights = _MeshedParams(params, mcfg, mesh)
    del params
    header = torch.empty(3, dtype=torch.int64, device=device)
    windows = 0
    while True:
        torch.distributed.broadcast(header, src=0)
        op, bucket, chunk = (int(v) for v in header.tolist())
        if op == _OP_STOP:
            return windows
        if op == _OP_RELOAD:
            weights.receive(device)
            continue
        batch, seeds = _window_buffers(mcfg, dcfg, bucket,
                                       const["wenlan_table"].dtype, device)
        _broadcast_window(batch, seeds)
        args = (weights.local, const, mcfg, dcfg, gcfg, batch, rng, mesh)
        if op == _OP_DECODE:
            decoding.generate_sharded(*args, row_seeds=seeds)
        else:
            for _ in decoding.generate_stream_sharded(*args, row_seeds=seeds,
                                                      chunk=chunk):
                pass
        windows += 1


class GenerationService:
    """Threaded window-batching front over the decode engine.

    Args:
      params/const/mcfg/dcfg/gcfg: exactly what :func:`decoding.generate`
        takes, tensors on the serving device; ``gcfg`` is service-wide (the
        sampling hyperparameters are fixed at service start).
      buckets: ascending batch sizes to pad to.
      max_wait_ms: how long the batcher holds an open window for
        stragglers after the first request arrives. 0 = dispatch
        immediately (lowest latency, worst fill).
      base_seed: service-wide PRNG base; together with the per-request
        ``seed`` it fully determines a response.
      mesh: optional ``(data, model)`` mesh
        (:func:`mmtg_tpu_torch.parallel.mesh.make_mesh`); the service then
        runs on rank 0, decodes every window over the mesh, and the other
        ranks run :func:`serve_follower` with the same arguments. Every
        bucket must divide by the mesh's data size. Responses equal the
        single-device ones token for token.
    """

    def __init__(
        self,
        params,
        const,
        mcfg: ModelConfig,
        dcfg: DataConfig,
        gcfg: GenerateConfig,
        buckets: Sequence[int] = (8, 16, 32, 64),
        max_wait_ms: float = 25.0,
        base_seed: int = 0,
        mesh=None,
        max_queue_depth: int = 4096,
        stall_unhealthy_s: float = 120.0,
    ):
        if list(buckets) != sorted(set(int(b) for b in buckets)) or not buckets:
            raise ValueError(f"buckets must be ascending and unique: {buckets}")
        if mesh is not None:
            dp = pmesh.mesh_sizes(mesh)[0]
            bad = [b for b in buckets if int(b) % dp]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the mesh data "
                                 f"axis ({dp})")
            if torch.distributed.get_rank() != 0:
                raise RuntimeError("a meshed GenerationService runs on rank 0; "
                                   "the other ranks run serve_follower")
        self.mesh = mesh
        # a meshed service keeps its TP shard (self.params) and the full
        # tree's shapes; a /reload waits in _new_params for the next window
        self._weights = (_MeshedParams(params, mcfg, mesh) if mesh is not None
                         else None)
        self.params = params if mesh is None else self._weights.local
        self._new_params = None
        self.const = const
        self.mcfg = mcfg
        self.dcfg = dcfg
        self.device = const["wenlan_table"].device
        self.buckets = tuple(int(b) for b in buckets)
        self.gcfg = _service_gcfg(gcfg, self.buckets, mesh is not None)
        self.max_wait_ms = float(max_wait_ms)
        self._rng = prng.PRNGKey(base_seed, device=self.device)
        self.max_queue_depth = int(max_queue_depth)
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        # formed-but-uncollected windows; maxsize bounds them to 2
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread: Optional[threading.Thread] = None
        self._collector: Optional[threading.Thread] = None
        self._stopping = False
        # set when the batcher thread dies on an escaped error: submit()
        # then fails fast with the cause instead of queueing into a void
        self._engine_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        # Liveness: a decode call that never returns is a HANG, not a crash
        # — no exception fires. The progress clock is set when work arrives
        # at an idle service, when a window is formed and when one
        # completes; "stalled" = work pending AND no progress for
        # stall_unhealthy_s. /healthz then turns 503 so an orchestrator can
        # restart the process (the stuck call itself cannot be interrupted
        # from Python).
        self.stall_unhealthy_s = float(stall_unhealthy_s)
        self._last_progress = time.monotonic()
        self._inflight_count = 0  # formed windows not yet collected
        self._stats = {
            "requests": 0,
            "batches": 0,
            "padded_rows": 0,
            "errors": 0,
            "cancelled": 0,
            "rejected": 0,
            "served": 0,
            "tokens_served": 0,
            "streams": 0,
            "stream_tokens": 0,
        }
        self._latencies_ms: list = []
        self._t_start = time.monotonic()

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "GenerationService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mmtg-batcher")
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True, name="mmtg-collector")
        self._thread.start()
        self._collector.start()
        return self

    def stop(self, join_timeout_s: float = 120.0) -> None:
        if self._thread is None:
            return
        self._stopping = True  # submit() rejects from here on
        self._queue.put(None)
        self._thread.join(join_timeout_s)
        self._collector.join(join_timeout_s)
        wedged = (self._thread.is_alive() or self._collector.is_alive())
        if wedged:
            # a decode call that never returns cannot be interrupted from
            # Python — record the wedge, fail the queued work, and leave the
            # daemon threads to die with the process instead of hanging
            # shutdown forever
            self._engine_error = RuntimeError(
                f"engine wedged: worker threads did not join within "
                f"{join_timeout_s}s (in-flight device call never returned)"
            )
        self._thread = self._collector = None
        # belt-and-braces: fail any straggler that raced past the
        # _stopping check into the queue after the batcher drained it
        self._fail_queued(
            "service stopped before decoding" if not wedged
            else "service stopped while engine wedged"
        )
        self._stopping = False

    def _fail_queued(self, msg: str) -> None:
        while True:
            try:
                left = self._queue.get_nowait()
            except queue.Empty:
                return
            if left is not None and left.future.set_running_or_notify_cancel():
                err = RuntimeError(msg)
                left.future.set_exception(err)
                if left.blocks is not None:
                    # stream consumers wait on their block queue, not the
                    # future — surface the failure there too
                    left.blocks.put(err)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, bucket: Optional[int] = None,
               streams: bool = True) -> None:
        """Run ahead of traffic: one synthetic batch per bucket (or just
        ``bucket``) through the one-shot AND (``streams=True``) the chunked
        decode. On a GPU the first call builds and loads the CUDA kernels
        and warms the allocator and the library handles, so that the first
        real request does not pay for them."""
        sizes = self.buckets if bucket is None else (bucket,)
        sample = self._synthetic_sample()
        for b in sizes:
            batch, seeds = self._pack([_Pending(sample, 0, Future())] * 1, b)
            _to_host(self._decode(batch, seeds)[:1])
            if streams:
                for blk in self._decode_chunked(batch, seeds):
                    pass
                _to_host(blk[:1])

    # ---- client API ------------------------------------------------------

    @staticmethod
    def _norm_seed(seed: int) -> int:
        # two's-complement into int32: the seed rides a [B] int32 tensor
        # into fold_in, and a client-supplied 2**40 must not blow up the
        # whole window in _pack
        seed = int(seed) & 0xFFFFFFFF
        return seed - 2**32 if seed >= 2**31 else seed

    def _enqueue(self, pending: _Pending) -> None:
        """Liveness + depth checks, the actual put, and the enqueue/death
        race sweep — shared by :meth:`submit` and :meth:`stream`."""
        if self._thread is None or self._stopping:
            raise RuntimeError("service not started or stopping")
        if self._engine_error is not None or not self._thread.is_alive():
            raise RuntimeError(
                f"engine is down (batcher thread dead): {self._engine_error!r}"
                " — restart the service"
            )
        if self._queue.qsize() >= self.max_queue_depth:
            with self._lock:
                self._stats["rejected"] += 1
            raise ServiceOverloaded(
                f"request queue at max_queue_depth={self.max_queue_depth}"
            )
        with self._lock:
            if self._queue.qsize() + self._inflight_count == 0:
                # work arrives at an idle service: the stall clock starts
                # NOW, not at the last window of an hour ago — else
                # stats()["stalled_s"] (and /healthz) would report the idle
                # time as a stall until this request's window forms
                self._last_progress = time.monotonic()
        self._queue.put(pending)
        if self._engine_error is not None or not self._thread.is_alive():
            # closes the enqueue/death race: if the engine died between
            # the liveness check above and our put, the crash path's
            # queue drain may already have run — sweep again so THIS
            # request cannot hang on a dead engine
            self._fail_queued(
                f"engine died before decoding this request: "
                f"{self._engine_error!r}"
            )
        with self._lock:
            self._stats["requests"] += 1

    def submit(self, sample: Dict[str, np.ndarray], seed: int) -> Future:
        """Enqueue one sample; resolves to ``[1 + length]`` int32 tokens.

        Raises :class:`ServiceOverloaded` when the queue is at
        ``max_queue_depth`` (load is shed at the edge — HTTP 503 — rather
        than growing an unbounded host backlog)."""
        self._validate(sample)
        fut: Future = Future()
        self._enqueue(_Pending(
            {k: np.asarray(sample[k]) for k in SAMPLE_KEYS},
            self._norm_seed(seed), fut,
        ))
        return fut

    def generate_sync(self, sample, seed: int, timeout: float = 600.0):
        return self.submit(sample, seed).result(timeout=timeout)

    def stream(self, sample: Dict[str, np.ndarray], seed: int,
               chunk: Optional[int] = None):
        """Stream one request's tokens as they decode — ``[n]`` int32
        blocks (one 22-token lyric sentence per block by default).

        **Bit-identical to the batched path**: the per-row PRNG stream
        depends only on ``(base_seed, seed, step)``, so
        ``[START] + concat(blocks) == submit(sample, seed)`` token for
        token — a client can stream interactively and re-fetch the same
        lyric batched later.

        The request rides the SAME window batcher as :meth:`submit`: it is
        packed into the next window next to one-shot batch-mates, the window
        decodes in blocks, and the collector fans each decoded block out to
        this generator as it arrives. Overload sheds at the queue edge
        (:class:`ServiceOverloaded` from the first ``next()``) exactly like
        ``submit``. Enqueueing happens lazily on first ``next()`` — an
        unconsumed generator never occupies a window row; shape/seed
        validation is eager.

        ``chunk`` re-chunks delivery host-side (buffer/split of the
        service-wide decode cadence, one 22-token sentence per block); the
        cadence itself — and so time-to-first-block for chunk < 22 — stays
        the sentence frame."""
        self._validate(sample)
        if self._thread is None or self._stopping:
            raise RuntimeError("service not started or stopping")
        seed = self._norm_seed(seed)
        sample = {k: np.asarray(sample[k]) for k in SAMPLE_KEYS}
        want = (max(1, min(int(chunk), self.gcfg.length))
                if chunk else self.dcfg.sent_frame_length)

        def consume():
            q: "queue.Queue" = queue.Queue()
            self._enqueue(_Pending(sample, seed, Future(), blocks=q))
            with self._lock:
                self._stats["streams"] += 1
            buf = np.zeros((0,), np.int32)
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                if item is None:
                    break
                buf = np.concatenate([buf, item])
                while buf.size >= want:
                    yield buf[:want]
                    buf = buf[want:]
            if buf.size:
                yield buf

        return consume()

    def swap_params(self, new_params) -> None:
        """Hot-swap model weights. The window currently decoding finishes on
        the old weights; the next window sees the new ones (the batcher
        reads ``self.params`` once per window, and the swap is one atomic
        rebind). The new tree (tensors or numpy arrays) must have the
        serving model's structure and shapes; it is cast to the serving
        dtypes and moved to the serving device."""
        new_params = tree_map(torch.as_tensor, new_params)

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [shapes(v) for v in tree]
            return tuple(tree.shape)

        old = self.params if self.mesh is None else self._weights.template
        if shapes(old) != shapes(new_params):
            raise ValueError(
                "new params do not match the serving model's tree/shapes — "
                "a different architecture needs a new service"
            )
        # f32 checkpoints into a bf16 serving model is the normal flow
        new_params = tree_map(
            lambda n, o: n.to(device=self.device, dtype=o.dtype), new_params, old)
        if self.mesh is None:
            self.params = new_params
        else:
            # the followers must take it between two windows: the batcher
            # broadcasts it before its next one (_sync_params)
            with self._lock:
                self._new_params = new_params

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._stats)
            lat = sorted(self._latencies_ms)
            pending = self._queue.qsize() + self._inflight_count
            out["pending"] = pending
            # seconds without work arriving at an idle service, a window
            # forming or one completing WHILE work is pending — the hang
            # signal (0 when idle)
            out["stalled_s"] = round(
                time.monotonic() - self._last_progress, 1
            ) if pending > 0 else 0.0
        n_b = max(out["batches"], 1)
        # "served" counts rows whose window COMPLETED (collector-side);
        # using submitted-minus-cancelled here would let a backlog push
        # mean_batch above the largest bucket
        served = out["served"]
        out["mean_fill"] = served / max(served + out["padded_rows"], 1)
        out["mean_batch"] = served / n_b
        out["uptime_s"] = round(time.monotonic() - self._t_start, 1)
        out["tokens_per_s"] = round(
            out["tokens_served"] / max(out["uptime_s"], 1e-9), 1
        )
        if lat:
            out["p50_latency_ms"] = lat[len(lat) // 2]
            out["p95_latency_ms"] = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
        return out

    # ---- internals -------------------------------------------------------

    def _expected_shapes(self) -> Dict[str, tuple]:
        return _expected_shapes(self.mcfg, self.dcfg)

    def _validate(self, sample: Dict) -> None:
        """Strict per-key shape check at the edge. Anything less lets one
        bad request poison its window's batch-mates (np.stack raises inside
        the batcher)."""
        missing = [k for k in SAMPLE_KEYS if k not in sample]
        if missing:
            raise ValueError(f"sample missing keys: {missing}")
        for k, want in self._expected_shapes().items():
            got = np.asarray(sample[k]).shape
            if got != want:
                raise ValueError(f"{k} shape {got} != {want}")

    def _synthetic_sample(self) -> Dict[str, np.ndarray]:
        shapes = self._expected_shapes()
        d = {k: np.zeros(shapes[k], np.float32 if k in _FLOAT_KEYS else np.int32)
             for k in SAMPLE_KEYS}
        d["tpw_attention_mask"][:] = 1
        return d

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pack(
        self, reqs: Sequence[_Pending], bucket: int
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Stack request samples and pad to ``bucket`` rows (pad rows
        repeat row 0 with seed 0; their outputs are dropped at demux).
        Floats take the dtype of the WenLan table."""
        pad = bucket - len(reqs)
        rows = list(reqs) + [reqs[0]] * pad
        ftype = self.const["wenlan_table"].dtype
        batch = {}
        for k in SAMPLE_KEYS:
            if k in _FLOAT_KEYS:
                arr = np.stack([np.asarray(r.sample[k], np.float32) for r in rows])
                batch[k] = torch.from_numpy(arr).to(self.device, ftype)
            else:
                arr = np.stack([np.asarray(r.sample[k], np.int32) for r in rows])
                batch[k] = torch.from_numpy(arr).to(self.device)
        seeds = torch.tensor([r.seed for r in reqs] + [0] * pad,
                             dtype=torch.int32, device=self.device)
        return batch, seeds

    def _sync_params(self) -> None:
        """Meshed: hand a pending ``/reload`` to the followers (batcher
        thread, between windows) and keep this rank's shard of it."""
        with self._lock:
            new, self._new_params = self._new_params, None
        if new is None:
            return
        self._send(_OP_RELOAD)
        _broadcast_tree(new)
        self._weights.local = self._weights.shard(new)
        self.params = self._weights.local

    def _send(self, op: int, bucket: int = 0, chunk: int = 0) -> None:
        torch.distributed.broadcast(torch.tensor(
            [op, bucket, chunk], dtype=torch.int64, device=self.device), src=0)

    def _send_window(self, op: int, batch, seeds, chunk: int = 0) -> None:
        """Meshed: the followers take the window rank 0 is about to decode."""
        self._sync_params()
        self._send(op, seeds.shape[0], chunk)
        _broadcast_window(batch, seeds)

    def _decode(self, batch, seeds):
        if self.mesh is not None:
            self._send_window(_OP_DECODE, batch, seeds)
            return decoding.generate_sharded(
                self.params, self.const, self.mcfg, self.dcfg, self.gcfg, batch,
                self._rng, self.mesh, row_seeds=seeds)
        return decoding.generate(self.params, self.const, self.mcfg, self.dcfg,
                                 self.gcfg, batch, self._rng, row_seeds=seeds)

    def _decode_chunked(self, batch, seeds):
        """Chunked window decode for windows carrying stream subscribers:
        the generator of ``[bucket, n]`` blocks (one sentence frame per
        block). Token-identical to :meth:`_decode` for the same inputs —
        the per-step PRNG folds in the GLOBAL step index, so chunking never
        changes a token. The params snapshot is this call's read of
        ``self.params`` — hot-swap safe per window, like ``_decode``."""
        chunk = self.dcfg.sent_frame_length
        if self.mesh is not None:
            self._send_window(_OP_STREAM, batch, seeds, chunk)
            return decoding.generate_stream_sharded(
                self.params, self.const, self.mcfg, self.dcfg, self.gcfg, batch,
                self._rng, self.mesh, row_seeds=seeds, chunk=chunk)
        return decoding.generate_stream(
            self.params, self.const, self.mcfg, self.dcfg, self.gcfg, batch,
            self._rng, row_seeds=seeds, chunk=chunk)

    def _loop(self) -> None:
        """Batcher thread body: the dispatch loop plus the crash contract.

        Whatever takes the dispatch loop down — the graceful stop sentinel
        or an error that escapes its defensive catches (engine death: a
        BaseException out of the decode) — the ``finally`` releases the
        collector (its sentinel) and fails everything still queued, so no
        client ever hangs on a dead engine and ``stop()`` always joins.
        """
        try:
            self._dispatch_loop()
            if self.mesh is not None:
                self._send(_OP_STOP)  # graceful drain: the followers return
        except BaseException as e:
            with self._lock:
                self._stats["errors"] += 1
            self._engine_error = e
            raise
        finally:
            self._inflight.put(None)
            # anything still queued fails loudly instead of hanging its
            # client (_fail_queued respects already-cancelled futures)
            self._fail_queued(
                "engine died before decoding this request: "
                f"{self._engine_error!r}" if self._engine_error is not None
                else "service stopped before decoding"
            )

    def _fail_window(self, reqs, e: BaseException) -> None:
        with self._lock:
            self._stats["errors"] += 1
        for r in reqs:
            r.future.set_exception(e)
            if r.blocks is not None:
                r.blocks.put(e)

    def _dispatch_loop(self) -> None:
        """Form a window, pack it, decode it and hand the result to the
        collector, which owns the device→host transfer and the futures. A
        window with a stream subscriber is handed over BEFORE it decodes, as
        a queue its blocks go into one by one, so that the collector
        delivers block 1 while block 2 decodes."""
        while True:
            first = self._queue.get()
            if first is None:
                # graceful drain (stop sentinel); _loop's finally fails
                # any straggler that raced in behind the sentinel
                return
            reqs = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(reqs) < self.buckets[-1]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    # drain stop sentinel AFTER serving what we have
                    self._queue.put(None)
                    break
                reqs.append(nxt)
            # honor client-side cancellation of still-queued requests (a
            # running window is never interrupted — its slots are shared)
            live = [r for r in reqs
                    if r.future.set_running_or_notify_cancel()]
            if len(live) != len(reqs):
                with self._lock:
                    self._stats["cancelled"] += len(reqs) - len(live)
            reqs = live
            if not reqs:
                continue
            bucket = self._bucket_for(len(reqs))
            with self._lock:
                self._inflight_count += 1
                self._last_progress = time.monotonic()  # window formed
            blocks: Optional["queue.Queue"] = None
            try:
                batch, seeds = self._pack(reqs, bucket)
                if any(r.blocks is not None for r in reqs):
                    blocks = queue.Queue()
                    self._inflight.put((reqs, bucket, blocks))
                    for blk in self._decode_chunked(batch, seeds):
                        blocks.put(blk)
                    blocks.put(None)
                    continue
                tokens = self._decode(batch, seeds)
            except BaseException as e:
                # Exception: one bad window — fail ITS requests, keep
                # serving. BaseException (engine death): fail the in-flight
                # window FIRST (these reqs are already dequeued, so _loop's
                # queue drain can't see them), then let it take the thread
                # down through _loop's crash path.
                if blocks is not None:
                    blocks.put(e)  # the collector holds the window: it fails it
                else:
                    with self._lock:
                        self._inflight_count -= 1
                    self._fail_window(reqs, e)
                # on a mesh the followers' place in the window is unknown
                # after a failure: the engine is down
                if isinstance(e, Exception) and self.mesh is None:
                    continue
                raise
            self._inflight.put((reqs, bucket, tokens))

    def _collect_stream(self, reqs, blocks: "queue.Queue"):
        """Bring a streamed window's blocks to the host one by one, fanning
        each out to its subscribers as it lands; returns the assembled
        ``[bucket, 1 + length]`` tokens, or the exception that ended it."""
        host_blocks = []
        n_streams = sum(r.blocks is not None for r in reqs)
        while True:
            blk = blocks.get()
            if blk is None:
                break
            if isinstance(blk, BaseException):
                return blk
            try:
                arr = _to_host(blk)  # waits until the block is decoded
            except Exception as e:  # pragma: no cover - defensive
                return e
            host_blocks.append(arr)
            with self._lock:
                self._last_progress = time.monotonic()
                self._stats["stream_tokens"] += arr.shape[1] * n_streams
            for i, r in enumerate(reqs):
                if r.blocks is not None:
                    r.blocks.put(arr[i])
        # the one-shot view: [START] + concat(blocks) == _decode's tokens
        full = np.concatenate(host_blocks, axis=1)
        start = np.full((full.shape[0], 1), SpecialTokens().start_id, full.dtype)
        return np.concatenate([start, full], axis=1)

    def _collect_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            reqs, bucket, tokens = item
            if isinstance(tokens, queue.Queue):
                tokens = self._collect_stream(reqs, tokens)
            else:
                try:
                    tokens = _to_host(tokens)  # waits until the decode is done
                except Exception as e:
                    tokens = e
            now = time.monotonic()
            if isinstance(tokens, BaseException):
                with self._lock:
                    self._inflight_count -= 1
                    self._last_progress = now
                self._fail_window(reqs, tokens)
                continue
            with self._lock:
                self._inflight_count -= 1
                self._last_progress = now
                self._stats["batches"] += 1
                self._stats["padded_rows"] += bucket - len(reqs)
                self._stats["served"] += len(reqs)
                self._stats["tokens_served"] += len(reqs) * (
                    tokens.shape[1] - 1
                )  # position 0 is the seeded [#START#], not generated
                self._latencies_ms.extend(
                    (now - r.t_submit) * 1e3 for r in reqs
                )
                del self._latencies_ms[:-1000]
            for i, r in enumerate(reqs):
                r.future.set_result(tokens[i])
                if r.blocks is not None:
                    r.blocks.put(None)  # done sentinel


# ---- HTTP front -----------------------------------------------------------


def prometheus_metrics(stats: Dict) -> str:
    """Render ``GenerationService.stats()`` in the Prometheus text
    exposition format (version 0.0.4) for the ``/metrics`` endpoint.

    Monotone counts become counters (``_total``), derived values become
    gauges, and the latency percentiles are exposed summary-style with a
    ``quantile`` label, in seconds per Prometheus naming conventions."""
    counters = {
        "requests": ("requests_total", "Rows accepted by submit()"),
        "batches": ("windows_total", "Decode windows dispatched"),
        "padded_rows": ("padded_rows_total", "Pad rows added to windows"),
        "served": ("served_rows_total", "Rows whose window completed"),
        "tokens_served": ("tokens_served_total", "Generated tokens"),
        "rejected": ("rejected_total", "Rows shed at the queue edge"),
        "cancelled": ("cancelled_total", "Rows cancelled before dispatch"),
        "errors": ("errors_total", "Windows failed in decode/collect"),
        "streams": ("streams_total", "Streaming requests started"),
        "stream_tokens": ("stream_tokens_total",
                          "Tokens delivered over streaming lanes"),
    }
    gauges = {
        "mean_fill": ("window_fill_ratio", "served/(served+padded) rows"),
        "mean_batch": ("window_mean_rows", "Mean served rows per window"),
        "uptime_s": ("uptime_seconds", "Seconds since service start"),
        "tokens_per_s": ("tokens_per_second", "tokens_served/uptime"),
        "pending": ("pending_rows", "Queued + in-flight rows"),
        "stalled_s": ("stalled_seconds",
                      "Seconds without window progress while work pends"),
    }
    lines: list = []
    for kind, table in (("counter", counters), ("gauge", gauges)):
        for key, (name, help_) in table.items():
            if key in stats:
                lines += [f"# HELP mmtg_{name} {help_}",
                          f"# TYPE mmtg_{name} {kind}",
                          f"mmtg_{name} {stats[key]}"]
    quantiles = [(q, stats[k] / 1e3) for q, k in
                 (("0.5", "p50_latency_ms"), ("0.95", "p95_latency_ms"))
                 if k in stats]
    if quantiles:
        lines += ["# HELP mmtg_request_latency_seconds Submit-to-tokens latency",
                  "# TYPE mmtg_request_latency_seconds summary"]
        lines += [f'mmtg_request_latency_seconds{{quantile="{q}"}} {v}'
                  for q, v in quantiles]
    return "\n".join(lines) + "\n"


_BAD_REQUEST = (KeyError, ValueError, TypeError, json.JSONDecodeError,
                zipfile.BadZipFile)


class _Handler(BaseHTTPRequestHandler):
    # quiet the default per-request stderr lines
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _json(self, code: int, payload: Dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_request(self) -> Dict:
        """The body of /generate or /generate_stream, JSON or npz, as
        ``sample`` / ``seed`` / ``timeout`` / ``text`` / ``chunk``."""
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n)
        ctype = self.headers.get("Content-Type", "")
        if NPZ_CONTENT_TYPE in ctype or body[:4] == _ZIP_MAGIC:
            sample, meta = decode_request_npz(body)
            return dict(meta, sample=sample, chunk=None)
        req = json.loads(body or b"{}")
        return {
            "sample": {k: np.asarray(v) for k, v in req["sample"].items()},
            "seed": int(req.get("seed", 0)),
            "timeout": float(req.get("timeout", 600)),
            "text": bool(req.get("text", True)),
            "chunk": int(req["chunk"]) if req.get("chunk") is not None else None,
        }

    def do_GET(self):  # noqa: N802
        svc: GenerationService = self.server.service  # type: ignore[attr-defined]
        if self.path == "/healthz":
            st = svc.stats()
            if st["stalled_s"] > svc.stall_unhealthy_s:
                # engine wedged (decode call never returned): report
                # unhealthy so the orchestrator restarts
                self._json(503, {"ok": False, "stalled_s": st["stalled_s"],
                                 "pending": st["pending"]})
            else:
                self._json(200, {"ok": True})
        elif self.path == "/stats":
            self._json(200, svc.stats())
        elif self.path == "/metrics":
            body = prometheus_metrics(svc.stats()).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _stream_post(self, svc: "GenerationService") -> None:
        """POST /generate_stream — Server-Sent Events: one ``data:`` event
        per decoded block (default one 22-token lyric sentence), then a
        terminal ``{"done": true}`` event. Body as /generate (JSON or
        npz); JSON additionally takes ``chunk`` (tokens per event).
        Token-identical to /generate for the same (sample, seed) —
        ``[START] + concat(event tokens) == /generate's "tokens"``."""
        try:
            req = self._read_request()
            t0 = time.monotonic()
            it = svc.stream(req["sample"], req["seed"], chunk=req["chunk"])
            first = next(it)  # enqueueing and the prefill happen here:
            # errors must surface BEFORE the 200/event-stream header
        except ServiceOverloaded as e:
            self._json(503, {"error": str(e)})
            return
        except _BAD_REQUEST as e:
            self._json(400, {"error": str(e)})
            return
        except Exception as e:  # pragma: no cover - defensive
            self._json(500, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        tok = getattr(self.server, "tokenizer", None)
        n_tokens = 0

        def emit(block) -> None:
            nonlocal n_tokens
            n_tokens += int(block.size)
            ev: Dict = {"tokens": block.tolist()}
            if tok is not None and req["text"]:
                ev["text"] = decoding.postprocess_tokens(block, tok)
            self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode("utf-8"))
            self.wfile.flush()

        try:
            emit(first)
            for block in it:
                emit(block)
            done = {"done": True, "seed": req["seed"], "tokens_total": n_tokens,
                    "latency_ms": (time.monotonic() - t0) * 1e3}
            self.wfile.write(f"data: {json.dumps(done)}\n\n".encode("utf-8"))
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up; the window decodes on for its batch-mates
        finally:
            # ALWAYS close (no-op after exhaustion): the suspended
            # generator holds the request's block queue — close it now
            # rather than when the GC finds it
            it.close()

    def do_POST(self):  # noqa: N802
        svc: GenerationService = self.server.service  # type: ignore[attr-defined]
        if self.path == "/reload":
            # checkpoint hot-swap: in-flight windows finish on the old
            # weights, the next window serves the new ones
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                from mmtg_tpu_torch.generate import load_params

                svc.swap_params(load_params(req["model_path"], svc.mcfg))
                self._json(200, {"ok": True, "model_path": req["model_path"]})
            except (KeyError, ValueError, TypeError, json.JSONDecodeError,
                    FileNotFoundError, NotImplementedError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                # a corrupt checkpoint or permissions: a JSON 500 beats a
                # dropped socket for the operator
                self._json(500, {"error": str(e)})
            return
        if self.path == "/generate_stream":
            self._stream_post(svc)
            return
        if self.path != "/generate":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            req = self._read_request()
            t0 = time.monotonic()
            tokens = svc.generate_sync(req["sample"], req["seed"],
                                       timeout=req["timeout"])
            out = {
                "tokens": np.asarray(tokens).tolist(),
                "seed": req["seed"],
                "latency_ms": (time.monotonic() - t0) * 1e3,
            }
            tok = getattr(self.server, "tokenizer", None)
            if tok is not None and req["text"]:
                out["text"] = decoding.postprocess_tokens(tokens, tok)
            self._json(200, out)
        except ServiceOverloaded as e:
            self._json(503, {"error": str(e)})
        except _BAD_REQUEST as e:
            # malformed JSON, bad shapes, or a truncated/corrupt npz body
            self._json(400, {"error": str(e)})
        except Exception as e:  # pragma: no cover - defensive
            self._json(500, {"error": str(e)})


def serve_http(
    service: GenerationService,
    host: str = "127.0.0.1",
    port: int = 8000,
    tokenizer=None,
) -> ThreadingHTTPServer:
    """Bind the HTTP front (caller runs ``serve_forever``, possibly in a
    thread). ``port=0`` binds an ephemeral port (tests)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.service = service  # type: ignore[attr-defined]
    httpd.tokenizer = tokenizer  # type: ignore[attr-defined]
    return httpd


# ---- CLI ------------------------------------------------------------------


def build_arg_parser():
    from mmtg_tpu_torch.generate import build_arg_parser as gen_parser

    p = gen_parser()
    p.description = "MMTG generation server (PyTorch)"
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--buckets", default="8,16,32,64", type=str,
                   help="ascending batch buckets a window is padded to")
    p.add_argument("--max_wait_ms", default=25.0, type=float,
                   help="window the batcher holds open for stragglers")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the synthetic batch per bucket at startup")
    p.add_argument("--max_queue_depth", default=4096, type=int,
                   help="shed load (HTTP 503) past this many queued requests")
    p.add_argument("--max_streams", default=None, type=int,
                   help="DEPRECATED no-op (kept for CLI compat): streams "
                        "ride the window batcher — capacity and shedding "
                        "are governed by --max_queue_depth like every other "
                        "request")
    p.add_argument("--stall_unhealthy_s", default=120.0, type=float,
                   help="/healthz turns 503 when work is pending but no "
                        "window formed or completed for this long (a decode "
                        "call that never returns is a hang, not a crash; "
                        "the orchestrator should restart on it)")
    return p


def _serving_setup(args, mcfg: Optional[ModelConfig], dcfg: Optional[DataConfig]):
    """What the service and its followers are built from: device, mesh
    (``None`` without mesh flags), tokenizer, configs (or the injected tiny
    test ones), GenerateConfig, checkpoint, WenLan table, buckets."""
    from mmtg_tpu_torch.bpe import load_tokenizer
    from mmtg_tpu_torch.data import load_token_embedding_table
    from mmtg_tpu_torch.generate import load_params, mesh_from_args, resolve_device

    device = resolve_device(args.device)
    mesh, device = mesh_from_args(args, device)
    tokenizer = load_tokenizer(args.tokenizer_path)
    if mcfg is None or dcfg is None:
        if args.variant == "english":
            from mmtg_tpu_torch.configs import english_variant

            mcfg, dcfg = english_variant(clip_dim=args.clip_dim,
                                         gpt2_vocab=len(tokenizer))
        else:
            mcfg, dcfg = ModelConfig(), DataConfig()
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # 'auto' weights/cache resolve inside GenerationService.__init__ (once
    # per service, from the largest bucket — see the invariance note there)
    gcfg = GenerateConfig(
        temperature=args.temperature,
        top_k=args.topk,
        top_p=args.topp,
        repetition_penalty=args.repetition_penalty,
        length=dcfg.max_seq_length,
        type_id_scheme=args.type_id_scheme,
        cache_dtype=args.cache_dtype,
        weight_dtype=args.weight_dtype,
        topk_impl=args.topk_impl,
        attn_impl=args.attn_impl,
        merged_kv=args.merged_kv,
    )
    params = load_params(args.model_path, mcfg, device)
    table = torch.from_numpy(load_token_embedding_table(
        args.token_emb_path, len(tokenizer), dcfg.wenlan_emb_size)).to(device)
    return dict(mesh=mesh, tokenizer=tokenizer, mcfg=mcfg, dcfg=dcfg, gcfg=gcfg,
                params=params, const={"wenlan_table": table}, buckets=buckets)


def build_service(args, mcfg: Optional[ModelConfig] = None,
                  dcfg: Optional[DataConfig] = None):
    """Everything between parsed args and a started service (on rank 0 of
    a meshed job). Returns ``(service, tokenizer)`` — split from
    :func:`main` so the CLI wiring is testable without ``serve_forever``."""
    s = _serving_setup(args, mcfg, dcfg)
    if getattr(args, "max_streams", None) is not None:
        import warnings

        warnings.warn(
            "--max_streams is deprecated and ignored: streams ride the "
            "window batcher (capacity = --max_queue_depth)",
            DeprecationWarning, stacklevel=2,
        )
    service = GenerationService(
        s["params"], s["const"], s["mcfg"], s["dcfg"], s["gcfg"],
        buckets=s["buckets"],
        max_wait_ms=args.max_wait_ms,
        base_seed=args.seed,
        mesh=s["mesh"],
        max_queue_depth=args.max_queue_depth,
        stall_unhealthy_s=args.stall_unhealthy_s,
    ).start()
    return service, s["tokenizer"]


def run_follower(args, mcfg: Optional[ModelConfig] = None,
                 dcfg: Optional[DataConfig] = None) -> int:
    """A meshed CLI's rank other than 0: :func:`serve_follower` on what
    :func:`build_service` builds on rank 0, until rank 0 stops."""
    s = _serving_setup(args, mcfg, dcfg)
    return serve_follower(s["params"], s["const"], s["mcfg"], s["dcfg"],
                          s["gcfg"], s["mesh"], s["buckets"], base_seed=args.seed)


def main(argv=None, mcfg: Optional[ModelConfig] = None,
         dcfg: Optional[DataConfig] = None) -> None:
    args = build_arg_parser().parse_args(argv)
    from mmtg_tpu_torch.utils.logging import setup_logger

    logger = setup_logger()
    meshed = (args.mesh_data, args.mesh_model) != (1, 1)
    if meshed and int(os.environ.get("RANK", "0")) != 0:
        # rank 0 alone binds the port; the others follow its windows
        n = run_follower(args, mcfg, dcfg)
        logger.info("Follower rank %d stopped after %d windows",
                    torch.distributed.get_rank(), n)
        torch.distributed.destroy_process_group()
        return
    service, tokenizer = build_service(args, mcfg, dcfg)
    if not args.no_warmup:
        logger.info("Warming up buckets %s ...", args.buckets)
        service.warmup()
    httpd = serve_http(service, args.host, args.port, tokenizer=tokenizer)
    logger.info("Serving on http://%s:%d (buckets %s, window %.0f ms, %s, pid %d)",
                args.host, httpd.server_address[1], args.buckets,
                args.max_wait_ms, service.device, os.getpid())
    # SIGTERM (systemd/k8s stop) must drain like Ctrl-C does: raise
    # KeyboardInterrupt out of serve_forever so the finally block runs
    # httpd.shutdown() + service.stop() (stop() serves what's queued)
    import signal

    def _sigterm(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        if service.mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
