"""Graph ops: segment kernels, edge aggregation, normalisation."""
