"""The port's command-line entry points: ``python -m
openseg3d_tpu_torch.tools.train`` and ``... .tools.eval``."""
