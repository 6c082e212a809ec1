"""One gloo job of the port's meshed train step on the CPU, launched by
``tests/test_torch_train_mesh.py``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        tests/_torch_train_mesh_job.py INPUTS.pt OUT.npz

Every rank loads the same inputs (configs, full parameters, the global batch,
a batch that keeps no sample), then for each case — meshes (4, 1), (2, 2),
(1, 4), ZeRO-1 on (4, 1) and (2, 2), all with remat under the policy "auto"
resolves to, and (2, 2) under "full" — shards the train state, takes this
rank's rows, computes the step's gradients (gathered to the full tree), runs
two train steps (the state gathered to full after them), a step on the
zero-kept batch, and checks the replicated leaves bit-equal on every rank.
Then, on (2, 2) with dropout on, the dropout seeds every rank drew and the
replicated residual stream of every rank. Rank 0 writes all results to one
``.npz`` (keys ``"<case>/<what>"``). Only the port is imported here."""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import train as ttrain  # noqa: E402
from mmtg_tpu_torch.models import gpt2  # noqa: E402
from mmtg_tpu_torch.models.mmtg import mmtg_forward_train  # noqa: E402
from mmtg_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mmtg_tpu_torch.params import tree_leaves  # noqa: E402

# (name, mesh, zero1, remat policy): "auto" resolves to "save_qkv_ctx" at
# these shapes; "2x2_full" keeps the whole-block recompute under TP covered
CASES = (("4x1", (4, 1), False, "auto"), ("2x2", (2, 2), False, "auto"),
         ("1x4", (1, 4), False, "auto"), ("4x1_zero1", (4, 1), True, "auto"),
         ("2x2_zero1", (2, 2), True, "auto"), ("2x2_full", (2, 2), False, "full"))
STAGE, ZERO_STAGE = 2, 1


def _np_tree(tree, prefix, out):
    for i, leaf in enumerate(tree_leaves(tree)):
        out[f"{prefix}/{i}"] = leaf.detach().numpy()


def _all_ranks_true(flag: bool) -> bool:
    t = torch.tensor([1.0 if flag else 0.0])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item() == 1.0)


def _replicated_equal(state, layout) -> bool:
    """Every replicated leaf bit-equal on every rank of the job."""
    ok = True
    for leaf, sharded in zip(tree_leaves(state.params),
                             layout.sharded_mask(state.params)):
        if sharded:
            continue
        parts = [torch.empty_like(leaf) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, leaf.detach().contiguous())
        ok &= all(torch.equal(p, parts[0]) for p in parts)
    return ok


def _rows(batch, mesh):
    """This rank's rows of a numpy batch, as tensors."""
    return ttrain._to_device(ttrain.local_batch(batch, mesh), "cpu")


def run_case(inputs, name, shape, zero1, policy, out):
    mcfg, dcfg = inputs["mcfg"], inputs["dcfg"]
    tcfg = dataclasses.replace(inputs["tcfg"], remat_policy=policy)
    mesh = pmesh.make_mesh(shape)
    layout = pmesh.train_layout(mesh)
    full, tx = ttrain.create_train_state(0, mcfg, tcfg, inputs["warmup"],
                                         inputs["total"], inputs["params"],
                                         device="cpu")
    state = ttrain.shard_train_state(full, mcfg, mesh, zero1=zero1)
    batch = _rows(inputs["batch"], mesh)
    const = inputs["const"]
    out[f"{name}/policy"] = np.array([ttrain._resolve_remat_policy(
        policy, batch, None, dcfg.topic_prompt_length, layout.dp)])
    # the step's gradients, as the step computes them, gathered to full
    grads, num = ttrain._numerators(
        state.params, const, mcfg, dcfg, tcfg, batch, STAGE, None,
        tp_group=layout.split_group if layout.tp > 1 else None, pp=None)
    grads, num, norm = ttrain._MeshSums(layout, state.params).reduce(grads, num)
    g_full = ttrain._full_tree(ttrain._unflatten(state.params, grads), mcfg, layout)
    m = ttrain._metrics(num)
    for k in ("loss", "kl", "total", "kept"):
        out[f"{name}/{k}"] = np.array([float(m[k])])
    out[f"{name}/norm"] = np.array([float(norm)])
    _np_tree(g_full, f"{name}/grad", out)
    # two steps, then the full state
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx, zero1=zero1, mesh=mesh)
    for i in range(2):
        state, m = step(state, const, batch, STAGE)
        out[f"{name}/step{i}_total"] = np.array([float(m["total"])])
    if zero1:
        local = sum(p.numel() for p in tree_leaves(state.params))
        out[f"{name}/moment_numel"] = np.array([state.opt_state["mu"].numel(), local])
    gathered = ttrain.gather_train_state(state, mcfg, mesh, zero1=zero1)
    _np_tree(gathered.params, f"{name}/params", out)
    _np_tree(gathered.opt_state["mu"], f"{name}/mu", out)
    _np_tree(gathered.opt_state["nu"], f"{name}/nu", out)
    out[f"{name}/count"] = np.array([int(gathered.opt_state["count"])])
    out[f"{name}/replicated_equal"] = np.array([_all_ranks_true(
        _replicated_equal(state, layout))])
    # a batch that keeps no sample: nothing changes on any rank
    before = [t.detach().clone() for t in tree_leaves(state.params)
              + tree_leaves(state.opt_state)]
    state, m = step(state, const, _rows(inputs["zero_batch"], mesh), ZERO_STAGE)
    after = tree_leaves(state.params) + tree_leaves(state.opt_state)
    same = all(torch.equal(a, b.detach()) for a, b in zip(before, after))
    out[f"{name}/zero_kept"] = np.array([float(m["kept"])])
    out[f"{name}/zero_kept_noop"] = np.array([_all_ranks_true(same)])
    out[f"{name}/zero_kept_step"] = np.array([state.step])


def run_dropout(inputs, out):
    """(2, 2) with dropout on: the seeds each rank drew in a train step, and
    the replicated residual stream (the stack's output) of each rank."""
    mcfg, dcfg = inputs["mcfg_dropout"], inputs["dcfg"]
    tcfg = inputs["tcfg_dropout"]
    mesh = pmesh.make_mesh((2, 2))
    layout = pmesh.train_layout(mesh)
    full, tx = ttrain.create_train_state(0, mcfg, tcfg, inputs["warmup"],
                                         inputs["total"], inputs["params"],
                                         device="cpu")
    state = ttrain.shard_train_state(full, mcfg, mesh)
    batch = _rows(inputs["batch"], mesh)
    drawn = []
    real = gpt2.dropout_seeds

    def capture(*a, **k):
        drawn.append(real(*a, **k))
        return drawn[-1]

    gpt2.dropout_seeds = capture
    try:
        step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx, mesh=mesh)
        state, _ = step(state, inputs["const"], batch, 3)
    finally:
        gpt2.dropout_seeds = real
    seeds = drawn[0]
    mine = np.array([seeds.embd] + [s for pair in seeds.resid for s in pair]
                    + list(seeds.attn), np.int64)
    gathered = [torch.empty(len(mine), dtype=torch.int64)
                for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, torch.from_numpy(mine))
    out["dropout/seeds"] = torch.stack(gathered).numpy()
    # the stack's output with dropout on, every rank
    gen = torch.Generator().manual_seed(1234 + layout.data_index)
    with torch.no_grad():
        o = mmtg_forward_train(state.params, inputs["const"], mcfg, dcfg, batch,
                               dropout_gen=gen, deterministic=False,
                               lm_head=False, tp_group=layout.split_group)
    parts = [torch.empty_like(o.hidden) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, o.hidden.contiguous())
    out["dropout/hidden"] = torch.stack(parts).numpy()


def main(argv) -> int:
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    inputs = torch.load(argv[0], weights_only=False)  # written by the test
    out = {}
    for name, shape, zero1, policy in CASES:
        run_case(inputs, name, shape, zero1, policy, out)
    run_dropout(inputs, out)
    if dist.get_rank() == 0:
        np.savez(argv[1], **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
