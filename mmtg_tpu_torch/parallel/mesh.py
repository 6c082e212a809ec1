"""The ``(data, model)`` process mesh, the tensor-parallel layout, the
collectives the port writes by hand, and ZeRO-1 (:mod:`mmtg_tpu.parallel.mesh`).

One process ("rank") per mesh position, started by ``torchrun`` (``python -m
torch.distributed.run``). :func:`init_distributed` reads the launcher's
environment and joins the process group; :func:`make_mesh` lays the ranks out
as a ``DeviceMesh`` with dimensions ``("data", "model")``, rank ``r`` at
``(r // tp, r % tp)``. The ``model`` dimension is Megatron-style tensor
parallelism over the GPT-2 blocks: head-aligned column shards of the fused
QKV and of the MLP's first product, row shards of the two output
projections (their partial products are summed over the ``model`` group),
everything else — embeddings, LayerNorms, the projection biases, the LM head
and every non-GPT-2 parameter — replicated. JAX places the shards through
``shard_map`` from partition specs; here each rank holds only its own
(:func:`shard_decode_params`; training shards its parameters and moments
in the same layout by :func:`decode_shard` and gathers them by
:func:`gather_params`). The JAX trainer also
shards ``wte`` / ``wpe`` over features; the port keeps them replicated,
which moves where they live, not what is computed.

The training half: :class:`TrainLayout` tells a train step which leaves its
rank holds a shard of (the TP-split weights, or the pipeline stage's layers,
:mod:`mmtg_tpu_torch.parallel.pipeline`) and which it holds whole, and the
groups to reduce over; :class:`Zero1Partition` is ZeRO-1's flat split of the
AdamW moments over the ``data`` group (each data rank keeps and updates
``1/dp`` of the elements, then the parameters are rebuilt by one
``all_gather``).

**The backend rule.** NCCL when every rank of the node has a card of its
own; gloo otherwise — on the CPU, and when ranks share a card (NCCL refuses
two ranks on one GPU). :func:`backend_for` is the rule and
:func:`init_distributed` returns what it chose. Gloo takes CUDA tensors in
``all_reduce`` SUM and MAX, ``broadcast`` and ``all_gather`` (it stages them
through the host itself), but not in ``send`` / ``recv``: under gloo the
point-to-point transfers of a pipeline (:func:`send` / :func:`recv`) are
staged through the host by this module (:func:`p2p_on_host`, decided by the
backend and the tensor's device, never by trying). Every collective of the
train path goes through the functions here, which count them
(:data:`comm`).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
LAUNCH_HINT = ("launch every rank with torchrun: python -m torch.distributed.run "
               "--nproc_per_node N -m <module> ...")


def backend_for(device_type: str, ranks_on_node: int, cards_on_node: int) -> str:
    """``"nccl"`` when the ranks run on CUDA and each rank of the node has a
    card of its own, else ``"gloo"`` (the CPU, or ranks sharing a card)."""
    if device_type == "cuda" and 0 < ranks_on_node <= cards_on_node:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """This process's place in the job, as :func:`init_distributed` set it."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str


def init_distributed(device="cuda") -> DistInfo:
    """Join the job ``torchrun`` started: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR`` / ``MASTER_PORT``
    from the environment. Rank ``r`` runs on ``cuda:(LOCAL_RANK %
    device_count)`` (set as the current device) or on the CPU. Without a
    launcher's environment the process is a job of one rank (an in-process
    store, no port). Joining twice returns the group already joined."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    on_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device (pass "
                               "device='cpu' to run the ranks on the CPU)")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    else:
        cards = 0
    backend = backend_for(device.type, on_node, cards)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"init_distributed: the process group runs "
                               f"{dist.get_backend()}, the rule gives {backend}")
    elif "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        if world != 1:
            raise RuntimeError(f"init_distributed: WORLD_SIZE={world} without "
                               f"a launcher's MASTER_ADDR; {LAUNCH_HINT}")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return DistInfo(dist.get_rank(), dist.get_world_size(), local_rank, device,
                    backend)


def make_mesh(mesh_shape: Tuple[int, int], device="cpu"):
    """A ``DeviceMesh`` of ``dp x tp`` ranks, dimensions ``("data",
    "model")``. Every rank of the job calls it. ``dp * tp`` must be the
    job's world size; a ``(1, 1)`` mesh without a process group joins a
    job of one rank (as JAX's ``make_mesh((1, 1))`` is one device)."""
    from torch.distributed.device_mesh import DeviceMesh

    dp, tp = (int(s) for s in mesh_shape)
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {mesh_shape}: both sizes must be >= 1")
    if not dist.is_initialized():
        if dp * tp != 1:
            raise RuntimeError(f"mesh ({dp}, {tp}) needs {dp * tp} ranks and no "
                               f"process group is running; {LAUNCH_HINT}")
        init_distributed(device)
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"mesh ({dp}, {tp}) needs {dp * tp} ranks, the job has "
                         f"{world}; {LAUNCH_HINT}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(dp, tp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_sizes(mesh) -> Tuple[int, int]:
    """``(dp, tp)``."""
    return mesh.size(0), mesh.size(1)


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's ``(data index, model index)`` (``(data, stage)`` on a
    ``("data", "pipe")`` mesh)."""
    return mesh.get_local_rank(0), mesh.get_local_rank(1)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated in group order
    (counted in :data:`comm`)."""
    if dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    comm._run("all_gather", x, lambda: dist.all_gather(parts, x.contiguous(),
                                                       group=group))
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# Tensor-parallel decode layout
# ---------------------------------------------------------------------------
# The fused QKV columns are [Q | K | V], head-major within each. A plain split
# of the last dim would give shard 0 "all of Q and half of K"; regrouped
# shard-major, a contiguous split gives each shard its heads' q, k and v.


def regroup_qkv_for_tp(attn_w, attn_b, n_head: int, head_dim: int, n_shards: int):
    """``[L, D, 3D]`` / ``[L, 3D]`` fused-QKV columns from ``[Q|K|V]`` to
    ``[q_s0|k_s0|v_s0 | q_s1|k_s1|v_s1 | ...]``."""
    if n_head % n_shards:
        raise ValueError(f"n_head {n_head} not divisible by tp={n_shards}")
    L, D, threeD = attn_w.shape
    chunk = (n_head // n_shards) * head_dim  # one shard's width of q (= k = v)
    w = attn_w.reshape(L, D, 3, n_shards, chunk).transpose(2, 3).reshape(L, D, threeD)
    b = attn_b.reshape(L, 3, n_shards, chunk).transpose(1, 2).reshape(L, threeD)
    return w, b


def tp_decode_params(params: Dict, n_head: int, head_dim: int, n_shards: int) -> Dict:
    """The MMTG parameter tree with the GPT-2 fused QKV regrouped for an
    ``n_shards``-way decode (everything else shared, not copied)."""
    h = dict(params["gpt2"]["h"])
    h["attn_w"], h["attn_b"] = regroup_qkv_for_tp(h["attn_w"], h["attn_b"],
                                                  n_head, head_dim, n_shards)
    return dict(params, gpt2=dict(params["gpt2"], h=h))


# the dimension each GPT-2 layer weight is split on under TP; the rest of the
# tree is replicated (the LM head too: one [B, D] x [D, V] product a step is
# cheaper than gathering the vocabulary every step)
DECODE_SPLIT_DIMS = {
    "attn_w": 2, "attn_b": 1,  # column-parallel QKV (regrouped)
    "attn_proj_w": 1,  # row-parallel
    "mlp_fc_w": 2, "mlp_fc_b": 1,  # column-parallel
    "mlp_proj_w": 1,  # row-parallel
}


def decode_param_splits(params: Dict) -> Dict:
    """The tree of split dims (``None`` = replicated) of
    ``decode_param_pspecs``: an ``int`` for the six TP-split GPT-2 layer
    weights, ``None`` everywhere else (:func:`tp_split_dim`)."""
    return _walk(params, lambda path, x: tp_split_dim(path))


def decode_shard(params: Dict, n_head: int, head_dim: int, tp: int,
                 index: int) -> Dict:
    """Shard ``index`` of ``tp`` of the MMTG tree: the regrouped QKV and the
    other split weights cut to their ``1/tp`` slice (contiguous copies), the
    replicated leaves shared."""
    if not 0 <= index < tp:
        raise ValueError(f"shard {index} of {tp}")
    if tp == 1:
        return params
    regrouped = tp_decode_params(params, n_head, head_dim, tp)

    def cut(x, dim):
        if dim is None:
            return x
        n = x.shape[dim] // tp
        return x.narrow(dim, index * n, n).contiguous()

    def walk(tree, splits):
        if isinstance(tree, dict):
            return {k: walk(tree[k], splits[k]) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(t, s) for t, s in zip(tree, splits))
        return cut(tree, splits)

    return walk(regrouped, decode_param_splits(regrouped))


def shard_decode_params(params: Dict, mesh, n_head: int, head_dim: int) -> Dict:
    """This rank's TP shard of the full MMTG tree (its ``model`` index)."""
    return decode_shard(params, n_head, head_dim, mesh_sizes(mesh)[1],
                        mesh_coords(mesh)[1])


def local_rows(n: int, mesh) -> slice:
    """This rank's rows of a global batch of ``n`` (its ``data`` index)."""
    dp = mesh_sizes(mesh)[0]
    if n % dp:
        raise ValueError(f"batch of {n} rows does not divide over the mesh "
                         f"data axis ({dp})")
    i = mesh_coords(mesh)[0]
    return slice(i * (n // dp), (i + 1) * (n // dp))


def groups(mesh) -> Tuple[object, object]:
    """The ``(data, model)`` process groups this rank belongs to."""
    return mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS)



def unregroup_qkv_for_tp(attn_w, attn_b, n_head: int, head_dim: int, n_shards: int):
    """Inverse of :func:`regroup_qkv_for_tp`: shard-major columns back to
    ``[Q|K|V]``."""
    L, D, threeD = attn_w.shape
    chunk = (n_head // n_shards) * head_dim
    w = attn_w.reshape(L, D, n_shards, 3, chunk).transpose(2, 3).reshape(L, D, threeD)
    b = attn_b.reshape(L, n_shards, 3, chunk).transpose(1, 2).reshape(L, threeD)
    return w, b


def require_multihost_flag(multihost: bool) -> None:
    """A job whose ranks span nodes (``LOCAL_WORLD_SIZE < WORLD_SIZE``) is
    joined only with ``--multihost``, as the JAX trainer sees only its local
    devices without it; ``--multihost`` needs the launcher's environment
    (``torchrun --nnodes N --node_rank i --master_addr ... --master_port
    ...``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``)."""
    env = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
           "LOCAL_WORLD_SIZE")
    if multihost:
        missing = [k for k in env if k not in os.environ]
        if missing:
            raise RuntimeError(f"--multihost joins a job a launcher started; "
                               f"{', '.join(missing)} not set ({LAUNCH_HINT}, "
                               "with --nnodes / --node_rank / --master_addr / "
                               "--master_port on every node)")
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    on_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if on_node < world:
        raise RuntimeError(f"the job spans nodes ({on_node} of its {world} ranks "
                           "on this one): pass --multihost")


# ---------------------------------------------------------------------------
# Collectives of the train path (counted)
# ---------------------------------------------------------------------------


class CommStats:
    """Counts of the train path's collectives: ``calls`` and ``bytes`` by
    kind. With ``timed`` set, each call also synchronizes the card before
    and after it and adds its host-clock time to ``seconds`` (a measurement
    mode: it removes the overlap of the card's queue with the transfer)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    def total_calls(self) -> int:
        return sum(self.calls.values())

    def _run(self, kind: str, x: torch.Tensor, fn):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + x.numel() * x.element_size()
        if not self.timed:
            return fn()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0
        return out


comm = CommStats()


def p2p_on_host(x: torch.Tensor, group=None) -> bool:
    """Whether a point-to-point transfer of ``x`` is staged through the host:
    gloo moves CPU buffers only (a CUDA tensor handed to its ``send`` aborts
    the process), so under gloo a CUDA tensor is copied to the host, sent,
    received into a host buffer and copied to the card. NCCL moves it on the
    card."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (counted)."""
    if group is not None and dist.get_world_size(group) == 1:
        return x
    comm._run("all_reduce", x, lambda: dist.all_reduce(x, group=group))
    return x


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` from global rank ``src`` to every rank of ``group``, in place
    (counted)."""
    if group is not None and dist.get_world_size(group) == 1:
        return x
    comm._run("broadcast", x, lambda: dist.broadcast(x, src, group=group))
    return x


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """``x`` to global rank ``dst`` (counted; through the host under the
    rule of :func:`p2p_on_host`)."""
    x = x.contiguous()
    buf = x.cpu() if p2p_on_host(x, group) else x
    comm._run("send", x, lambda: dist.send(buf, dst, group=group))


def recv(shape, dtype, device, src: int, group=None) -> torch.Tensor:
    """A tensor of ``shape`` / ``dtype`` from global rank ``src``, on
    ``device`` (counted; through the host under :func:`p2p_on_host`)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    host = p2p_on_host(out, group)
    buf = torch.empty(shape, dtype=dtype) if host else out
    comm._run("recv", out, lambda: dist.recv(buf, src, group=group))
    if host:
        out.copy_(buf)
    return out


# ---------------------------------------------------------------------------
# The train layout: which leaves a rank holds a shard of, and where to reduce
# ---------------------------------------------------------------------------


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def tp_split_dim(path) -> Optional[int]:
    """The dim a leaf at ``path`` is split on under TP (``None``:
    replicated)."""
    if len(path) == 3 and path[:2] == ("gpt2", "h"):
        return DECODE_SPLIT_DIMS.get(path[2])
    return None


def gather_params(local: Dict, n_head: int, head_dim: int, group) -> Dict:
    """Every rank's TP shard over ``group`` → the full tree in the JAX
    package's layout (QKV columns back to ``[Q|K|V]``), on every rank.
    Inverse of :func:`decode_shard` (training shards a tree, parameters or
    AdamW moments, in the decode layout)."""
    tp = dist.get_world_size(group)
    if tp == 1:
        return local
    full = _walk(local, lambda path, x: x if tp_split_dim(path) is None
                 else all_gather_cat(x.detach(), group, tp_split_dim(path)))
    h = dict(full["gpt2"]["h"])
    h["attn_w"], h["attn_b"] = unregroup_qkv_for_tp(h["attn_w"], h["attn_b"],
                                                    n_head, head_dim, tp)
    return dict(full, gpt2=dict(full["gpt2"], h=h))


@dataclasses.dataclass
class TrainLayout:
    """A train step's view of its mesh: a ``("data", "model")`` mesh
    (:func:`make_mesh`) or a ``("data", "pipe")`` one
    (:func:`mmtg_tpu_torch.parallel.pipeline.make_dp_pp_mesh`).

    ``split`` is the size of the second axis (``tp`` or the stage count)
    and ``part`` this rank's index on it. A leaf is *sharded* when the rank
    holds a part of it (a TP-split weight, a stage's layers) and
    *replicated* when every rank holds all of it. Gradients of sharded
    leaves are summed over ``data``; those of replicated leaves are the
    same on every rank of a data shard, so ranks with ``part > 0`` zero
    theirs and one sum over the whole job gives every rank the part-0
    ranks' sum over ``data`` — bit-equal everywhere."""

    mesh: object
    axis: str  # "model" or "pipe"
    dp: int
    split: int
    data_index: int
    part: int
    data_group: object
    split_group: object

    @property
    def tp(self) -> int:
        return self.split if self.axis == MODEL_AXIS else 1

    @property
    def pp(self) -> int:
        return self.split if self.axis != MODEL_AXIS else 1

    def is_sharded(self, path) -> bool:
        if self.split == 1:
            return False
        if self.axis == MODEL_AXIS:
            return tp_split_dim(path) is not None
        return len(path) == 3 and path[:2] == ("gpt2", "h")

    def sharded_mask(self, tree) -> List[bool]:
        """``is_sharded`` of each leaf, in ``tree_leaves`` order."""
        from mmtg_tpu_torch.params import tree_leaves

        return tree_leaves(_walk(tree, lambda path, x: self.is_sharded(path)))


def train_layout(mesh) -> TrainLayout:
    names = tuple(mesh.mesh_dim_names)
    if names[0] != DATA_AXIS or len(names) != 2:
        raise ValueError(f"a train mesh has dims ('data', 'model' | 'pipe'), "
                         f"not {names}")
    return TrainLayout(mesh=mesh, axis=names[1], dp=mesh.size(0),
                       split=mesh.size(1), data_index=mesh.get_local_rank(0),
                       part=mesh.get_local_rank(1),
                       data_group=mesh.get_group(0), split_group=mesh.get_group(1))


# ---------------------------------------------------------------------------
# ZeRO-1: the AdamW moments split over the data group
# ---------------------------------------------------------------------------


class Zero1Partition:
    """This data rank's share of a rank's parameters, flattened: the local
    leaves (a TP shard's, when TP is on) laid end to end, padded to a
    multiple of ``dp`` and cut into ``dp`` equal chunks; rank ``i`` keeps
    and updates chunk ``i`` of each moment. Flat chunks need no leaf to
    divide by ``dp`` (the JAX package picks a divisible dim a leaf and keeps
    the indivisible ones whole; either way a rank holds about ``1/dp`` of
    the elements)."""

    def __init__(self, leaves: List[torch.Tensor], dp: int, index: int):
        self.shapes = [tuple(p.shape) for p in leaves]
        self.sizes = [p.numel() for p in leaves]
        self.total = sum(self.sizes)
        self.dp, self.index = dp, index
        self.chunk = math.ceil(self.total / dp)

    def flat(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The tensors as one f32 vector, zero-padded to ``dp`` chunks."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.chunk * self.dp - self.total))

    def local(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.index * self.chunk:(self.index + 1) * self.chunk]

    def gather(self, chunk: torch.Tensor, group) -> torch.Tensor:
        """Every data rank's chunk → the full flat vector (unpadded)."""
        return all_gather_cat(chunk.contiguous(), group)[:self.total]

    def unflat(self, flat: torch.Tensor) -> List[torch.Tensor]:
        out, at = [], 0
        for shape, n in zip(self.shapes, self.sizes):
            out.append(flat[at:at + n].view(shape))
            at += n
        return out
