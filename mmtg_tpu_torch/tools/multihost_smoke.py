"""Multi-process (``--multihost``) smoke of the port (``tools/multihost_smoke.py``
of the JAX package): one REAL distributed train step.

One process a rank, started by ``torchrun``. Each rank joins the job
through the exact path ``python -m mmtg_tpu_torch.train --multihost`` takes
(``parallel/mesh.require_multihost_flag(True)``, then the train CLI's
process-group set-up, ``train._join_mesh``: gloo on the CPU, NCCL when each
rank has a card of its own), checks a known global sum over the job with an
``all_reduce``, then runs one full MMTG train step of the JAX tool's tiny
model over a global ``(world, 1)`` data mesh, each rank feeding its
``ROWS_PER_RANK`` rows of the global batch: the gradient sum spans the
processes, which a single-process run cannot certify.

``--dryrun`` then also runs, on the same job at the same size, a tensor-
parallel step on ``(1, world)``, a pipeline step on ``data x pipe`` (world/2
x 2), an eval step on the data mesh and ``generate_sharded`` on the data and
the model mesh (two sentence frames): the port's counterpart of the JAX
package's ``dryrun_multichip``, through the port's own mesh code.

Runs on the CUDA cards (``--device cpu`` to run the ranks on the CPU):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m mmtg_tpu_torch.tools.multihost_smoke --device cpu [--dryrun]
    # across nodes: torchrun --nnodes N --node_rank i --master_addr ... \\
    #     --master_port ... -m mmtg_tpu_torch.tools.multihost_smoke
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROWS_PER_RANK = 4  # the JAX tool's rows a process (one a virtual device)
STAGE = 2
GEN_LENGTH = 44  # two sentence frames
PROMPT_KEYS = ("topic_ids", "tpw_attention_mask", "tpw_type_ids", "topic_emb",
               "img_embs", "r_embs")


def tiny_configs():
    """The JAX tool's tiny but fully wired model (the JAX package's
    ``dryrun_multichip`` config) → ``(mcfg, dcfg, tcfg)``."""
    from mmtg_tpu_torch.configs import (ChannelConfig, DataConfig, GPT2Config,
                                        ModelConfig, TrainConfig)

    mcfg = ModelConfig(
        topic=ChannelConfig(input_dim=64, hidden_dim=32, type="MLP"),
        image=ChannelConfig(input_dim=64, hidden_dim=32),
        text=ChannelConfig(input_dim=64, hidden_dim=32),
        self_att_hidden_size=32,
        self_att_heads=4,
        mm_att_out_dim=64,
        gpt2=GPT2Config(vocab_size=256, n_positions=256, n_embd=64, n_layer=2,
                        n_head=4),
    )
    return mcfg, DataConfig(wenlan_emb_size=64), TrainConfig(lr=1e-3, alpha=0.2)


def make_batch(B: int, dcfg, vocab: int, rng: np.random.Generator) -> dict:
    """The JAX package's synthetic train batch of ``B`` rows
    (``__graft_entry__._make_batch``'s draws, in its order), as numpy."""
    P, T = dcfg.topic_prompt_length, dcfg.target_length
    E = dcfg.wenlan_emb_size
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "topic_ids": i32(rng.integers(100, vocab, (B, P))),
        "tpw_attention_mask": np.ones((B, P), np.int32),
        "tpw_type_ids": np.ones((B, P), np.int32),
        "topic_emb": f32(rng.standard_normal((B, E))),
        "img_embs": f32(rng.standard_normal((B, 5, E))),
        "r_embs": f32(rng.standard_normal((B, 5, E))),
        "targets": i32(rng.integers(100, vocab, (B, T))),
        "attention_mask": np.ones((B, T), np.int32),
        "type_ids": i32(rng.integers(0, 5, (B, T))),
        "rating": f32(rng.integers(1, 6, (B,))),
    }


def inputs(world: int, mcfg, dcfg):
    """The global batch (``ROWS_PER_RANK`` rows a rank, every rank drawing
    the same from seed 0) and the WenLan table drawn after it."""
    rng = np.random.default_rng(0)
    B = ROWS_PER_RANK * world
    batch = make_batch(B, dcfg, mcfg.gpt2.vocab_size, rng)
    batch["sample_mask"] = np.ones((B,), np.float32)
    const = {"wenlan_table": rng.standard_normal(
        (mcfg.gpt2.vocab_size, dcfg.wenlan_emb_size)).astype(np.float32)}
    return batch, const


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, type=str,
                    help="torch device (default: cuda; pass 'cpu' to run the "
                         "ranks on the CPU)")
    ap.add_argument("--dryrun", action="store_true",
                    help="also TP and pipeline steps, an eval step and "
                         "generate_sharded on the same job")
    return ap


def _join(device):
    """The train CLI's set-up for ``--multihost --mesh_data <world>``:
    ``(mesh, device)``."""
    from mmtg_tpu_torch import train as ttrain

    world = int(os.environ.get("WORLD_SIZE", "1"))
    n = str(ROWS_PER_RANK * world)
    args = ttrain.build_arg_parser().parse_args(
        ["--multihost", "--mesh_data", str(world), "--batch_size", n,
         "--val_batch_size", n])
    mesh, _, device = ttrain._join_mesh(args, device)
    return mesh, device


def _step(mcfg, dcfg, tcfg, params, const, batch, mesh, device, pp=None):
    """One train step of the full ``params`` on ``mesh`` (or ``pp = (mesh,
    n_micro)``), this rank feeding its rows → ``(state, metrics)``."""
    import torch

    from mmtg_tpu_torch import train as ttrain

    full, tx = ttrain.create_train_state(0, mcfg, tcfg, 2, 10, params, device=device)
    state = ttrain.shard_train_state(full, mcfg, mesh)
    rows = ttrain._to_device(ttrain.local_batch(batch, mesh), device)
    step = ttrain.make_train_step(mcfg, dcfg, tcfg, tx, pp=pp,
                                  mesh=None if pp is not None else mesh)
    state, m = step(state, const, rows, STAGE)
    loss = float(m["total"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state, m


def _dryrun(mcfg, dcfg, tcfg, params, const, batch, mesh, device) -> list:
    """TP, PP, eval and sharded decode on the job (see the module
    docstring) → one line a run."""
    import torch

    from mmtg_tpu_torch import train as ttrain
    from mmtg_tpu_torch.configs import GenerateConfig
    from mmtg_tpu_torch.decoding import generate_sharded
    from mmtg_tpu_torch.ops import prng
    from mmtg_tpu_torch.parallel import mesh as pmesh
    from mmtg_tpu_torch.parallel.pipeline import make_dp_pp_mesh

    world = torch.distributed.get_world_size()
    lines = []
    tp_mesh = pmesh.make_mesh((1, world), device)
    _, m = _step(mcfg, dcfg, tcfg, params, const, batch, tp_mesh, device)
    lines.append(f"tp (1,{world}) loss={float(m['total']):.4f}")
    if world % 2 == 0 and mcfg.gpt2.n_layer % 2 == 0:
        pp_mesh = make_dp_pp_mesh(world // 2, 2, device)
        _, m = _step(mcfg, dcfg, tcfg, params, const, batch, pp_mesh, device,
                     pp=(pp_mesh, 2))
        lines.append(f"pp ({world // 2}x2) loss={float(m['total']):.4f}")
    eval_step = ttrain.make_eval_step(mcfg, dcfg, tcfg, mesh=mesh)
    m = eval_step(params, const, ttrain._to_device(ttrain.local_batch(batch, mesh),
                                                   device), STAGE)
    lines.append(f"eval loss={float(m['total']):.4f}")
    prompt = ttrain._to_device({k: batch[k] for k in PROMPT_KEYS}, device)
    gcfg = GenerateConfig(length=GEN_LENGTH)
    for shape in ((world, 1), (1, world)):
        gm = mesh if shape == (world, 1) else tp_mesh
        toks = generate_sharded(params, const, mcfg, dcfg, gcfg, prompt,
                                prng.PRNGKey(1, device=device), gm)
        if tuple(toks.shape) != (len(batch["rating"]), GEN_LENGTH + 1):
            raise RuntimeError(f"generate_sharded {shape}: tokens {tuple(toks.shape)}")
        lines.append(f"generate_sharded {shape} tokens={tuple(toks.shape)}")
    return lines


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import torch

    from mmtg_tpu_torch.generate import resolve_device
    from mmtg_tpu_torch.parallel import mesh as pmesh
    from mmtg_tpu_torch import params as tparams

    device = resolve_device(args.device)
    # the path under test: the exact calls `--multihost` makes
    pmesh.require_multihost_flag(True)
    mesh, device = _join(device)
    dist = torch.distributed
    n_proc, pid = dist.get_world_size(), dist.get_rank()
    want = int(os.environ["WORLD_SIZE"])
    assert n_proc == want, f"world size {n_proc} != {want}"

    # --- cross-process collective sanity: a known global reduction -------
    rows = np.arange(n_proc, dtype=np.float32)
    x = torch.tensor(rows[pid:pid + 1], device=device)
    dist.all_reduce(x)
    got, expect = float(x.item()), float(rows.sum())
    assert got == expect, f"global sum {got} != {expect}"

    # --- one full distributed train step (the JAX tool's tiny model) -----
    mcfg, dcfg, tcfg = tiny_configs()
    batch, const_np = inputs(n_proc, mcfg, dcfg)
    # every rank starts from the same values (the same seed)
    params = tparams.tree_map(lambda p: p.to(device=device, dtype=torch.float32),
                              tparams.init_params(mcfg, seed=0))
    const = {k: torch.from_numpy(v).to(device) for k, v in const_np.items()}
    state, metrics = _step(mcfg, dcfg, tcfg, params, const, batch, mesh, device)
    loss = float(metrics["total"])
    print(f"multihost smoke OK pid={pid}/{n_proc}: global devices={n_proc} "
          f"({dist.get_backend()}, {device.type}) loss={loss:.4f} "
          f"step={int(state.step)}", flush=True)
    if args.dryrun:
        for line in _dryrun(mcfg, dcfg, tcfg, params, const, batch, mesh, device):
            print(f"dryrun pid={pid}/{n_proc}: {line}", flush=True)
        if pid == 0:
            print(f"dryrun OK: {n_proc} ranks", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
