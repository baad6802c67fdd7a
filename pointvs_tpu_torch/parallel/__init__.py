"""Train and eval steps (single device)."""
