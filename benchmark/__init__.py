"""The benchmark of openseg3d_tpu_torch: see run.py."""
