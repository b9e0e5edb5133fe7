"""Training loops, checkpoints."""
