"""Training: the synthetic packed-token data (copied), AdamW with a
cosine schedule, the train step over the cache-less forward, and npz
checkpoints that the JAX package's ``train.checkpoint`` reads and
writes too."""
