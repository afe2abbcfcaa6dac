"""Training (port of viewformer_tpu/train): the transformer train step and
loop, checkpoints and the metric log."""
