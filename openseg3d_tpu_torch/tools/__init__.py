"""The port's command-line entry points: ``python -m
openseg3d_tpu_torch.tools.train``, ``.tools.eval``, ``.tools.test``,
``.tools.profile_step``, ``.tools.measure_capacities`` and
``.tools.verify_capacities`` (the bench is ``openseg3d_tpu_torch.bench``)."""
