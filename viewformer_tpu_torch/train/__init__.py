"""Training (port of viewformer_tpu/train): the codebook and transformer
train steps and loops, checkpoints and the metric log."""
