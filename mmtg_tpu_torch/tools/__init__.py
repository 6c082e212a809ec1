"""The serving and latency tools of the port (the JAX package's ``tools/``
of the same names): load generators for :class:`mmtg_tpu_torch.serve.
GenerationService` and the decode latency matrix against its memory floor.

Each module runs as ``python -m mmtg_tpu_torch.tools.<name>`` on the CUDA
card (``--device cpu`` to run without one) and exposes ``run(args,
mcfg=None, dcfg=None, observe=None, weights=None)`` beside ``main(argv)``:
``mcfg`` / ``dcfg`` drive it at another model configuration, ``observe``
wraps each measured scenario, ``weights`` reuses a model already built by
:func:`~mmtg_tpu_torch.tools.serve_common.build_model`."""
