"""Model config, parameter declarations, rotary embeddings, layers and the
paged-cache forward."""
