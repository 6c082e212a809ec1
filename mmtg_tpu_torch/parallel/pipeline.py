"""GPipe pipeline parallelism for the GPT-2 block stack
(:mod:`mmtg_tpu.parallel.pipeline`).

The stacked ``[L, ...]`` layer parameters are split over the ``pipe`` axis of
a ``("data", "pipe")`` mesh (:func:`make_dp_pp_mesh`; rank ``r`` at ``(r //
pp, r % pp)``): stage ``s`` holds layers ``[s·L/S, (s+1)·L/S)``
(:func:`shard_params_pp`). Every other leaf — embeddings, final LayerNorm,
encoder, attention, projector — stays whole and identical on every rank, as
JAX keeps it replicated on every device.

The schedule is plain GPipe over point-to-point transfers in the ``pipe``
group (:func:`pipeline_stack`). Forward: ``M + S − 1`` ticks; stage ``s``
runs its layers on micro-batch ``t − s`` at tick ``t`` (it receives the
activations from stage ``s − 1`` and sends its own to ``s + 1``); the last
stage's outputs are broadcast to every stage, which all compute the loss.
Backward, which JAX gets by differentiating through ``shard_map`` and the
port writes by hand: the last stage takes d(output) of each micro-batch from
its own loss, every stage recomputes its layers on the micro-batch's saved
input (full remat a stage: only the inputs are kept), back-propagates the
gradient it received from stage ``s + 1`` and sends d(input) to ``s − 1``;
stage 0 hands d(input) back to the embedding. The stages' gradients of the
replicated leaves are combined by the train step
(:class:`mmtg_tpu_torch.parallel.mesh.TrainLayout`). Bubble:
``(S − 1)/(M + S − 1)``.

Under gloo the transfers of CUDA tensors go through the host
(:func:`mmtg_tpu_torch.parallel.mesh.p2p_on_host`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from mmtg_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    LAUNCH_HINT,
    all_gather_cat,
    broadcast_,
    recv,
    send,
)

PIPE_AXIS = "pipe"


def make_dp_pp_mesh(dp: int, pp: int, device="cpu"):
    """A ``DeviceMesh`` of ``dp x pp`` ranks with dims ``("data", "pipe")``:
    gradient sums over ``data``, activations over ``pipe``. ``dp * pp`` must
    be the job's world size."""
    from torch.distributed.device_mesh import DeviceMesh

    if dp < 1 or pp < 1:
        raise ValueError(f"mesh ({dp}, {pp}): both sizes must be >= 1")
    if not dist.is_initialized() or dist.get_world_size() != dp * pp:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise ValueError(f"mesh ({dp}, {pp}) needs {dp * pp} ranks, the job has "
                         f"{have}; {LAUNCH_HINT}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(dp * pp).reshape(dp, pp),
                      mesh_dim_names=(DATA_AXIS, PIPE_AXIS))


def _stage_range(n_layer: int, pp: int, stage: int) -> slice:
    if n_layer % pp:
        raise ValueError(f"n_layer {n_layer} not divisible by pipe={pp}")
    n = n_layer // pp
    return slice(stage * n, (stage + 1) * n)


def shard_params_pp(params: Dict, pp: int, stage: int) -> Dict:
    """Stage ``stage``'s tree: the ``gpt2/h`` leaves cut to its layers, the
    rest shared. Also takes a tree of AdamW moments."""
    h = params["gpt2"]["h"]
    rows = _stage_range(next(iter(h.values())).shape[0], pp, stage)
    local = {k: v[rows] for k, v in h.items()}
    return dict(params, gpt2=dict(params["gpt2"], h=local))


def gather_params_pp(local: Dict, group) -> Dict:
    """Every stage's layers over ``group`` → the full tree, on every rank."""
    h = {k: all_gather_cat(v.detach(), group, 0)
         for k, v in local["gpt2"]["h"].items()}
    return dict(local, gpt2=dict(local["gpt2"], h=h))


def _pipe_ranks(mesh) -> List[int]:
    """The global ranks of this rank's pipe group, in stage order."""
    return [int(r) for r in mesh.mesh[mesh.get_local_rank(0)]]


class _GPipe(torch.autograd.Function):
    """The schedule under autograd: inputs ``h`` and the stage's parameter
    tensors, output the stack's output on every stage."""

    @staticmethod
    def forward(ctx, plan, h, *stage_params):
        run_stage, mesh, n_micro, aux, keys = plan
        ranks = _pipe_ranks(mesh)
        S, s = len(ranks), mesh.get_local_rank(1)
        group = mesh.get_group(1)
        B = h.shape[0]
        mb = B // n_micro
        params = dict(zip(keys, stage_params))
        inputs, outs = [], torch.empty_like(h)
        for m in range(n_micro):
            rows = slice(m * mb, (m + 1) * mb)
            if s == 0:
                x = h[rows]
            else:
                x = recv((mb,) + tuple(h.shape[1:]), h.dtype, h.device, ranks[s - 1],
                         group)
            inputs.append(x)
            y = run_stage(x, params, [a[rows] for a in aux], m)
            if s < S - 1:
                send(y, ranks[s + 1], group)
            else:
                outs[rows] = y
        broadcast_(outs, ranks[-1], group)
        ctx.plan, ctx.inputs = plan, inputs
        ctx.save_for_backward(*stage_params)
        return outs

    @staticmethod
    def backward(ctx, d_out):
        run_stage, mesh, n_micro, aux, keys = ctx.plan
        stage_params = ctx.saved_tensors
        ranks = _pipe_ranks(mesh)
        S, s = len(ranks), mesh.get_local_rank(1)
        group = mesh.get_group(1)
        mb = d_out.shape[0] // n_micro
        want = [ctx.needs_input_grad[2 + i] for i in range(len(stage_params))]
        leaves = [p.detach().requires_grad_(w) for p, w in zip(stage_params, want)]
        params = dict(zip(keys, leaves))
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               if w else None for p, w in zip(stage_params, want)]
        d_h = torch.zeros_like(d_out) if s == 0 and ctx.needs_input_grad[1] else None
        for m in range(n_micro):
            rows = slice(m * mb, (m + 1) * mb)
            x = ctx.inputs[m]
            if s == S - 1:
                dy = d_out[rows]
            else:
                dy = recv(tuple(x.shape), x.dtype, x.device, ranks[s + 1], group)
            x = x.detach().requires_grad_(s > 0 or d_h is not None)
            with torch.enable_grad():
                y = run_stage(x, params, [a[rows] for a in aux], m)
                wrt = ([x] if x.requires_grad else []) + [p for p in leaves
                                                          if p.requires_grad]
                grads = list(torch.autograd.grad(y, wrt, dy, allow_unused=True))
            dx = grads.pop(0) if x.requires_grad else None
            for a in acc:
                if a is not None:
                    g = grads.pop(0)
                    if g is not None:
                        a.add_(g.float())
            if s > 0:
                send(dx, ranks[s - 1], group)
            elif d_h is not None:
                d_h[rows] = dx
        ctx.inputs = None
        return (None, d_h, *(None if a is None else a.to(p.dtype)
                             for a, p in zip(acc, stage_params)))


def pipeline_stack(run_stage: Callable, stage_params: Dict[str, torch.Tensor],
                   h: torch.Tensor, aux: Sequence[torch.Tensor], mesh,
                   n_micro: int) -> torch.Tensor:
    """``h`` ``[B, T, D]`` through every stage's layers, GPipe-pipelined over
    ``mesh``'s ``pipe`` axis; returns the stack's output on every stage.

    ``run_stage(x, params, aux_m, m)`` runs this stage's layers (``params``:
    its ``[L/S, ...]`` leaves) on micro-batch ``m``'s activations ``x``
    ``[B/M, T, D]``; ``aux`` are batch-leading tensors it needs (the key bias),
    sliced to the micro-batch as ``aux_m``. ``run_stage`` must be a pure
    function of its arguments (dropout masks from seeds folded with ``m``):
    the backward runs it again. Stage 0's ``h`` is the input; the other
    stages' ``h`` gives shape and dtype only and gets no gradient."""
    if h.shape[0] % n_micro:
        raise ValueError(f"per-rank batch {h.shape[0]} not divisible by "
                         f"n_micro={n_micro}")
    keys = sorted(stage_params)
    plan = (run_stage, mesh, int(n_micro), [a.contiguous() for a in aux], keys)
    return _GPipe.apply(plan, h, *(stage_params[k] for k in keys))
