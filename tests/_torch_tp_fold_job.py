"""One gloo job of two ranks on the CPU, launched by
``tests/test_torch_tp_fold.py``:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        tests/_torch_tp_fold_job.py INPUTS.pt OUT.npz

On a (1, 2) mesh: ``generate_sharded`` with row seeds (f32, the model-dtype
cache), the ordered fold ``models/gpt2.tp_sum`` of a row-parallel product
against the product of the whole weight, with ``tp_sum.calls`` a product,
and what ``shard_decode_params`` raises for bf16 shards that do not cut at
the full plan's K ranges. Rank 0 writes the results to one ``.npz``. Only
the port is imported here."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import decoding  # noqa: E402
from mmtg_tpu_torch.models import gpt2  # noqa: E402
from mmtg_tpu_torch.ops import prng  # noqa: E402
from mmtg_tpu_torch.ops.matmul import matmul_plain  # noqa: E402
from mmtg_tpu_torch.params import tree_to  # noqa: E402
from mmtg_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def run(inputs: dict) -> dict:
    mcfg, dcfg, gcfg = inputs["mcfg"], inputs["dcfg"], inputs["gcfg"]
    params, const, batch = inputs["params"], inputs["const"], inputs["batch"]
    mesh = pmesh.make_mesh((1, 2))
    _, group = pmesh.groups(mesh)
    out = {"seeds": decoding.generate_sharded(
        params, const, mcfg, dcfg, gcfg, batch, prng.PRNGKey(inputs["key_seed"]), mesh,
        row_seeds=inputs["row_seeds"])}
    # one row-parallel product: this rank's K half, folded over the group
    x, w, b = inputs["x"], inputs["w"], inputs["b"]
    i, half = dist.get_rank(group), w.shape[0] // 2
    calls = gpt2.tp_sum.calls
    out["fold"] = gpt2.tp_sum(x[:, i * half:(i + 1) * half].contiguous(),
                              w[i * half:(i + 1) * half], group, matmul_plain, b)
    out["fold_calls"] = np.array(gpt2.tp_sum.calls - calls)
    g = mcfg.gpt2
    try:
        pmesh.shard_decode_params(tree_to(params, dtype=torch.bfloat16), mesh, g.n_head,
                                  g.head_dim)
        out["bf16_error"] = np.array("")
    except ValueError as e:
        out["bf16_error"] = np.array(str(e))
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def main(argv) -> int:
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    inputs = torch.load(argv[0], weights_only=False)  # written by the test
    with torch.no_grad():
        out = run(inputs)
    if dist.get_rank() == 0:
        np.savez(argv[1], **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
