"""Checkpoints of arrays and of mutable indexes (`store.CheckpointManager`)."""
