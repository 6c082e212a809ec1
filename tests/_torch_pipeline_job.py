"""One gloo job of the port's GPipe train path on the CPU, launched by
``tests/test_torch_pipeline.py``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        tests/_torch_pipeline_job.py INPUTS.pt OUT.npz

Every rank loads the same inputs, lays the four ranks out as data 2 x pipe 2
(``parallel.pipeline.make_dp_pp_mesh``), shards the train state by stage and
takes its data shard's rows, then: the eval metrics, the step's gradients
(gathered to the full tree; the same under each explicit remat policy),
two train steps (the state gathered to full),
the replicated leaves compared across ranks, a step on a batch that keeps no
sample; and the stack with dropout on, twice with one seed and once with
another, on rows that repeat from one micro-batch to the next. Rank 0 writes
the results to one ``.npz``. Only the port is imported here."""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import train as ttrain  # noqa: E402
from mmtg_tpu_torch.models.gpt2 import gpt2_forward  # noqa: E402
from mmtg_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mmtg_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_dp_pp_mesh,
    shard_params_pp,
)
from mmtg_tpu_torch.params import tree_leaves  # noqa: E402

from _torch_train_mesh_job import _all_ranks_true, _np_tree, _replicated_equal, _rows  # noqa: E402

DP, PP, N_MICRO = 2, 2, 2
POLICIES = ("full", "save_qkv_ctx", "save_ctx_fc1", "save_all")
STAGE, ZERO_STAGE = 2, 1


def run(inputs, out):
    mcfg, dcfg, tcfg = inputs["mcfg"], inputs["dcfg"], inputs["tcfg"]
    mesh = make_dp_pp_mesh(DP, PP)
    pp = (mesh, N_MICRO)
    layout = pmesh.train_layout(mesh)
    full, tx = ttrain.create_train_state(0, mcfg, tcfg, inputs["warmup"],
                                         inputs["total"], inputs["params"],
                                         device="cpu")
    state = ttrain.shard_train_state(full, mcfg, mesh)
    out["local_layers"] = np.array([state.params["gpt2"]["h"]["attn_w"].shape[0]])
    batch, const = _rows(inputs["batch"], mesh), inputs["const"]
    m = ttrain.make_eval_step(mcfg, dcfg, tcfg, pp=pp)(state.params, const, batch,
                                                       STAGE)
    for k in ("loss", "kl", "total", "kept"):
        out[f"eval/{k}"] = np.array([float(m[k])])
    grads, num = ttrain._numerators(state.params, const, mcfg, dcfg, tcfg, batch,
                                    STAGE, None, pp=pp)
    # the pipeline recomputes each stage from its input under any policy: an
    # explicit one gives this rank the same numbers bit for bit
    for policy in POLICIES:
        g, n = ttrain._numerators(state.params, const, mcfg, dcfg,
                                  dataclasses.replace(tcfg, remat_policy=policy),
                                  batch, STAGE, None, pp=pp)
        same = torch.equal(n, num) and all(torch.equal(x, y) for x, y in zip(g, grads))
        out[f"policy/{policy}"] = np.array([_all_ranks_true(same)])
    grads, num, norm = ttrain._MeshSums(layout, state.params).reduce(grads, num)
    out["norm"] = np.array([float(norm)])
    _np_tree(ttrain._full_tree(ttrain._unflatten(state.params, grads), mcfg, layout),
             "grad", out)
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx, pp=pp)
    start = [p.detach().clone() for p in tree_leaves(state.params)]
    for _ in range(2):
        state, m = step(state, const, batch, STAGE)
    out["moved"] = np.array([max(float((p.detach() - s).abs().max())
                                 for p, s in zip(tree_leaves(state.params), start))])
    gathered = ttrain.gather_train_state(state, mcfg, mesh)
    _np_tree(gathered.params, "params", out)
    _np_tree(gathered.opt_state["mu"], "mu", out)
    _np_tree(gathered.opt_state["nu"], "nu", out)
    out["replicated_equal"] = np.array([_all_ranks_true(_replicated_equal(state,
                                                                         layout))])
    before = [t.detach().clone() for t in tree_leaves(state.params)
              + tree_leaves(state.opt_state)]
    state, m = step(state, const, _rows(inputs["zero_batch"], mesh), ZERO_STAGE)
    after = tree_leaves(state.params) + tree_leaves(state.opt_state)
    out["zero_kept"] = np.array([float(m["kept"])])
    out["zero_kept_noop"] = np.array([_all_ranks_true(
        all(torch.equal(a, b.detach()) for a, b in zip(before, after)))])

    # dropout in the stack only; rows 2, 3 (micro-batch 1) repeat rows 0, 1
    g = dataclasses.replace(mcfg.gpt2, embd_pdrop=0.0, resid_pdrop=0.1,
                            attn_pdrop=0.1)
    gp = shard_params_pp(inputs["params"], PP, layout.part)["gpt2"]
    x = torch.randn(2, 40, g.n_embd, generator=torch.Generator().manual_seed(5))
    x = torch.cat([x, x])
    pos = torch.arange(40)[None, :]

    def fwd(seed):
        with torch.no_grad():
            return gpt2_forward(gp, g, x, pos, dropout_gen=torch.Generator()
                                .manual_seed(seed), deterministic=False,
                                lm_head=False, pp=pp)[0]

    a, b, c = fwd(0), fwd(0), fwd(7)
    with torch.no_grad():
        d = gpt2_forward(gp, g, x, pos, deterministic=True, lm_head=False, pp=pp)[0]
    out["dropout/same_seed_equal"] = np.array([torch.equal(a, b)])
    out["dropout/other_seed_differs"] = np.array([not torch.allclose(a, c)])
    out["dropout/micro_batches_differ"] = np.array([not torch.allclose(a[:2], a[2:])])
    out["dropout/off_micro_batches_equal"] = np.array([torch.equal(d[:2], d[2:])])


def main(argv) -> int:
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    inputs = torch.load(argv[0], weights_only=False)  # written by the test
    out = {}
    run(inputs, out)
    if dist.get_rank() == 0:
        np.savez(argv[1], **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
