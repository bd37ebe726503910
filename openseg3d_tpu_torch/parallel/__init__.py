"""Data-parallel training over torch.distributed (``dist``)."""
