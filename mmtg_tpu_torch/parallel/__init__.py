"""Parallelism over ``torch.distributed``: the ``(data, model)`` mesh and the
tensor-parallel decode layout (:mod:`mmtg_tpu_torch.parallel.mesh`)."""
