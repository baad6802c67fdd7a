"""Metrics read back from predictions files."""
