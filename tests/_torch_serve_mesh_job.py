"""One gloo job of the port's meshed service and meshed generate CLI on the
CPU, launched by ``tests/test_torch_serve_mesh.py``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        tests/_torch_serve_mesh_job.py INPUTS.pt OUT.npz

On the meshes (4, 1) and (2, 2): rank 0 runs ``GenerationService(mesh=...)``
— three requests in one window, one streamed request, a weight swap and one
request after it — while the other ranks run ``serve_follower``. Then the
generate CLI (``generate.main``) on a (2, 2) mesh (``--mesh_data 0``). Rank 0
writes what it saw to one ``.npz``."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import generate, serve  # noqa: E402
from mmtg_tpu_torch.parallel import mesh as pmesh  # noqa: E402

MESHES = ((4, 1), (2, 2))
BUCKETS = (4,)


def _serve(inputs: dict, mesh, name: str, out: dict) -> None:
    mcfg, dcfg, gcfg = inputs["mcfg"], inputs["dcfg"], inputs["gcfg"]
    params, const, samples = inputs["params"], inputs["const"], inputs["samples"]
    if dist.get_rank() != 0:
        out[f"{name}/follower_windows"] = np.array(serve.serve_follower(
            params, const, mcfg, dcfg, gcfg, mesh, BUCKETS, base_seed=0))
        return
    try:
        serve.GenerationService(params, const, mcfg, dcfg, gcfg, buckets=(2, 4),
                                mesh=mesh)
        out[f"{name}/indivisible_error"] = np.array("")
    except ValueError as e:
        out[f"{name}/indivisible_error"] = np.array(str(e))
    svc = serve.GenerationService(params, const, mcfg, dcfg, gcfg, buckets=BUCKETS,
                                  max_wait_ms=1500.0, base_seed=0, mesh=mesh)
    out[f"{name}/cache_dtype"] = np.array(svc.gcfg.cache_dtype)
    with svc:
        futs = [svc.submit(samples[i], seed=50 + i) for i in range(3)]
        out[f"{name}/batched"] = np.stack([f.result(timeout=100) for f in futs])
        out[f"{name}/streamed"] = np.concatenate(list(svc.stream(samples[0], seed=31)))
        svc.swap_params(inputs["params_b"])
        out[f"{name}/after_swap"] = svc.generate_sync(samples[0], seed=50, timeout=100)
        out[f"{name}/windows"] = np.array(svc.stats()["batches"])


def main(argv) -> int:
    torch.set_num_threads(1)
    pmesh.init_distributed("cpu")
    inputs = torch.load(argv[0], weights_only=False)  # written by the test
    out = {}
    for dp, tp in MESHES:
        _serve(inputs, pmesh.make_mesh((dp, tp)), f"{dp}x{tp}", out)
    generate.main(inputs["generate_argv"], mcfg=inputs["mcfg"], dcfg=inputs["dcfg"])
    if dist.get_rank() == 0:
        np.savez(argv[1], **out)
    else:
        np.savez(f"{argv[1]}.rank{dist.get_rank()}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
