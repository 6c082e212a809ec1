"""The tools of the port (the JAX package's ``tools/`` of the same names).

The serving and latency tools are load generators for
:class:`mmtg_tpu_torch.serve.GenerationService` and the decode latency matrix
against its memory floor. Each runs as ``python -m
mmtg_tpu_torch.tools.<name>`` on the CUDA card (``--device cpu`` to run
without one) and exposes ``run(args, mcfg=None, dcfg=None, observe=None,
weights=None)`` beside ``main(argv)``: ``mcfg`` / ``dcfg`` drive it at another
model configuration, ``observe`` wraps each measured scenario, ``weights``
reuses a model already built by
:func:`~mmtg_tpu_torch.tools.serve_common.build_model`.

The rest: ``trace_train`` / ``trace_decode`` (per-op device time of a train
step and of a decode call from a ``torch.profiler`` trace; ``run(args,
mcfg=None, dcfg=None)``), ``bench_pack`` (host framing rate),
``multihost_smoke`` (one train step across processes under ``torchrun``),
``release_check`` (the one-command gate), ``make_fixtures`` (the demo
records and WenLan table), ``export_reference_ckpt`` (a train state to the
reference's ``.pth``), ``parity_check`` (the port's logits on a reference
``.pth``, on the card against its plain path on the CPU) and
``batch_invariance`` (a row's tokens at every batch size, and the op probe
that finds what moves them)."""
