"""Scoring engine (training arrives with the training slice)."""
