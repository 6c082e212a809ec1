"""One gloo job of the port's sharded decode on the CPU, launched by
``tests/test_torch_generate_sharded.py``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        tests/_torch_mesh_job.py INPUTS.pt OUT.npz

Every rank loads the same inputs (configs, params, batch, seeds, the
single-device reference tokens), then on each mesh of four ranks — (4, 1),
(2, 2) and (1, 4) — runs every case; rank 0 writes all results to one
``.npz`` (keys ``"<dp>x<tp>/<case>"``). Only the port is imported here."""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtg_tpu_torch import decoding  # noqa: E402
from mmtg_tpu_torch.ops import prng  # noqa: E402
from mmtg_tpu_torch.parallel import mesh as pmesh  # noqa: E402

MESHES = ((4, 1), (2, 2), (1, 4))


def _error(fn) -> str:
    """The message of what ``fn`` raises ("" when it returns)."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def run(inputs: dict) -> dict:
    mcfg, dcfg, gcfg = inputs["mcfg"], inputs["dcfg"], inputs["gcfg"]
    params, const, batch = inputs["params"], inputs["const"], inputs["batch"]
    seeds, key = inputs["row_seeds"], prng.PRNGKey(inputs["key_seed"])
    out = {}
    for dp, tp in MESHES:
        mesh = pmesh.make_mesh((dp, tp))
        name = f"{dp}x{tp}"
        args = (params, const, mcfg, dcfg, gcfg, batch, key, mesh)
        out[f"{name}/seeds"] = decoding.generate_sharded(*args, row_seeds=seeds)
        out[f"{name}/fold"] = decoding.generate_sharded(*args)
        out[f"{name}/generator"] = decoding.generate_sharded(
            *args[:6], torch.Generator().manual_seed(inputs["key_seed"]), mesh)
        out[f"{name}/stream_seeds"] = torch.cat(list(
            decoding.generate_stream_sharded(*args, row_seeds=seeds, chunk=7)), 1)
        out[f"{name}/stream_fold"] = torch.cat(list(
            decoding.generate_stream_sharded(*args)), 1)
        int8w = dataclasses.replace(gcfg, weight_dtype="int8")
        out[f"{name}/int8_weights"] = decoding.generate_sharded(
            params, const, mcfg, dcfg, int8w, batch, key, mesh, row_seeds=seeds)
        int8c = dataclasses.replace(gcfg, cache_dtype="int8")
        out[f"{name}/int8_cache_stream_error"] = np.array(_error(lambda: next(
            decoding.generate_stream_sharded(params, const, mcfg, dcfg, int8c,
                                             batch, key, mesh, row_seeds=seeds))))
        if tp > 1:
            # every rank a different key: the TP ranks of a shard part, and the
            # agreement check raises on all of them alike
            own = prng.PRNGKey(dist.get_rank())
            out[f"{name}/disagree_error"] = np.array(_error(
                lambda: decoding.generate_sharded(params, const, mcfg, dcfg, gcfg,
                                                  batch, own, mesh)))
        # the sharded step's logits on the single-device tokens, gathered
        rows = pmesh.local_rows(batch["topic_ids"].shape[0], mesh)
        data_group, model_group = pmesh.groups(mesh)
        g = mcfg.gpt2
        logits = decoding.teacher_forced_decode_logits(
            pmesh.shard_decode_params(params, mesh, g.n_head, g.head_dim), const,
            mcfg, dcfg, gcfg, {k: v[rows] for k, v in batch.items()},
            inputs["reference_tokens"][rows],
            tp_group=model_group if tp > 1 else None)
        out[f"{name}/tf_logits"] = pmesh.all_gather_cat(logits, data_group)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


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
