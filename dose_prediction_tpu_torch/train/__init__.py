"""Training: losses, train state and optimizer, train/eval steps."""
