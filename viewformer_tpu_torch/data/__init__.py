"""Datasets (port of viewformer_tpu/data): the TFRecord codec, the shard
writer and reader, the dataset generators (generate_dataset_from_loader,
transform_dataset), the training readers `load_image_dataset` and
`load_token_dataset`, and the sequence loaders of `loaders/` (colors,
dataset)."""
