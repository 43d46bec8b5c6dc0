"""Scoring: the batched embedding engine and the result CSVs."""
