"""Parallel training: data parallel over torch.distributed (distributed.py)."""
