"""Datasets (port of viewformer_tpu/data): the TFRecord codec, the shard
writer and reader, the training reader `load_token_dataset`, and the
sequence loaders of `loaders/` (colors, dataset)."""
