"""The ``(data, model)`` process mesh and the tensor-parallel decode layout
(:mod:`mmtg_tpu.parallel.mesh`, its decode half).

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
(:func:`shard_decode_params`).

**The backend rule.** NCCL when every rank of the node has a card of its
own; gloo otherwise — on the CPU, and when ranks share a card (NCCL refuses
two ranks on one GPU). :func:`backend_for` is the rule and
:func:`init_distributed` returns what it chose. Gloo takes CUDA tensors in
every collective the decode uses (``all_reduce`` SUM and MAX, ``broadcast``,
``all_gather``): it stages them through the host itself.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

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
    """This rank's ``(data index, model index)``."""
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated in group order."""
    if dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
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
    weights, ``None`` everywhere else."""

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        if len(path) == 3 and path[:2] == ("gpt2", "h"):
            return DECODE_SPLIT_DIMS.get(path[2])
        return None

    return walk(params)


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

