"""Host pipelines over the entry points (``for_steph``)."""
