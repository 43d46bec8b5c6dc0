"""Scoring: the batched embedding engine, the result CSVs and large-scale
scoring (counterpart of ``nomad_tpu.scoring``; ``build_result_tables`` is
the port's ``build_result_frames``, without pandas)."""

from .csvio import ResultTable, build_result_tables, file_label, write_results
from .engine import EmbeddingEngine, bucket_length, list_dir_files
from .large_scale import LargeScaleScorer, make_large_scale_scorer

__all__ = [
    "EmbeddingEngine",
    "LargeScaleScorer",
    "ResultTable",
    "bucket_length",
    "build_result_tables",
    "file_label",
    "list_dir_files",
    "make_large_scale_scorer",
    "write_results",
]
