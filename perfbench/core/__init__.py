"""The harness: cells found by name, inputs made from the seed, the
measured window, the traced span and the readers that turn them into
metrics. Nothing here imports the JAX package or JAX."""
