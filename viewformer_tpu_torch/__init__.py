"""viewformer_tpu_torch: the PyTorch and CUDA port of viewformer_tpu.

Runs the serving main path (encode -> prefill -> generate -> decode ->
localize) and transformer training (with and without dropout; the train
step, and the loop train_transformer with its token-dataset reader,
checkpoints and CLI, `python -m viewformer_tpu_torch train ...`) with
PyTorch on an NVIDIA H100, where the eight attention kernels, forward and
backward, are hand-written CUDA (csrc/). The entry points put their tensors
on the card unless the caller passes device='cpu'; on CPU tensors the
kernels' plain PyTorch versions run. The JAX package stays the reference;
this package imports nothing of it, and keeps its own copy of the config
(config.py).
"""
import torch

# The codebook search (ops/quantizer.nearest_codes) must run in full f32, as
# the reference's HIGHEST-precision product does: TF32 keeps ~3 decimal
# digits and flips codes near Voronoi boundaries. cuDNN convolutions default
# to TF32 as well; f32 convolutions are held to f32 with them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
