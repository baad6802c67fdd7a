"""Host data pipeline: types files, structures, graphs, padded batches."""
