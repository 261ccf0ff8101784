"""Training: losses, the train step, checkpoints and validation."""
