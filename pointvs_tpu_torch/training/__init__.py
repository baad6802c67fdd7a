"""Training and scoring engine: losses, optimisers, checkpoints, Trainer."""
