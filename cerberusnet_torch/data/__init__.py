"""Data: the synthetic dataset, batching and device preprocessing."""
