"""Training (port of viewformer_tpu/train): the transformer train step."""
