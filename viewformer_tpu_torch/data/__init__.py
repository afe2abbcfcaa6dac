"""Token datasets (port of the token half of viewformer_tpu/data): the
TFRecord codec, the shard writer and the training reader
`load_token_dataset`."""
