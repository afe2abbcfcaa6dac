"""viewformer_tpu_torch: the PyTorch and CUDA port of viewformer_tpu.

Runs on an NVIDIA H100, where the eight attention kernels, forward and
backward, are hand-written CUDA (csrc/):

- serving: the one-shot path (evaluate.transformer.generate_batch_predictions:
  encode -> prefill -> generate -> decode -> localize) and KV-cached
  sessions (serve.create_session / ServingSession: start, observe, render of
  N views, localize), with the JSONL protocol `python -m
  viewformer_tpu_torch serve`;
- evaluation: evaluate.transformer.evaluate_transformer,
  evaluate.multictx.evaluate_transformer_multictx and
  evaluate.codebook.evaluate_codebook over the loaders of data.loaders
  (colors, dataset), with the metrics of utils.metrics; `python -m
  viewformer_tpu_torch evaluate transformer|transformer-multictx|codebook`;
- the codebook stage: image datasets (`python -m viewformer_tpu_torch
  dataset generate`), codebook training (train.codebook.train_codebook:
  the EMA quantizer, LPIPS, `train codebook`) and the token datasets of
  commands.generate_codes (`generate-codes`);
- transformer training (with and without dropout; the train step, and the
  loop train_transformer with its token-dataset reader, checkpoints and
  CLI, `python -m viewformer_tpu_torch train ...`).

The entry points put their tensors on the card unless the caller passes
device='cpu'; on CPU tensors the kernels' plain PyTorch versions run. The
JAX package stays the reference; this package imports nothing of it, and
keeps its own copy of the config (config.py).
"""
import torch

# The codebook search (ops/quantizer.nearest_codes) must run in full f32, as
# the reference's HIGHEST-precision product does: TF32 keeps ~3 decimal
# digits and flips codes near Voronoi boundaries. cuDNN convolutions default
# to TF32 as well; f32 convolutions are held to f32 with them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
