"""Training: optimizer, compression, step, checkpoints, loop."""
