"""Step-atomic checkpoints in the JAX package's on-disk layout
(counterpart of ``repro.checkpoint``)."""
