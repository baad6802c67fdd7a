"""Structure files to the parquet schema (``types_to_parquet``)."""
