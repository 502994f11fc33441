"""Training: configuration, losses and the trainer."""
