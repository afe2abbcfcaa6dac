"""Parallel training and inference: the data axis over torch.distributed
(distributed.py), the (data, seq, model) mesh (mesh.py) and the tensor-
parallel layouts of MIGT (sharding.py)."""
