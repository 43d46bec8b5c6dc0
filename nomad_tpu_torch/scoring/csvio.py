"""Result CSVs in the reference's exact format, written with the stdlib
``csv`` module (counterpart of ``nomad_tpu.scoring.csvio``, which uses
pandas; the bytes are the same for the same matrix).

Contract (quirks Q2/Q3):
  * labels = ``path.split('/')[-1].split('.')[0]`` (basename, first dot);
  * scores rounded to 3 decimals and written as pandas writes them: the
    shortest repr of the value in its own float type ('0.334', '1.0');
  * avg CSV columns ``Test File,NOMAD``; pairwise CSV columns
    ``Test File`` + one column per NMR label; rows in input order;
  * default output dir ``results-csv/<dd-mm-YYYY_HH-MM-SS>/`` with files
    ``{ts}_nomad_avg.csv`` / ``{ts}_nomad_scores.csv``; with
    ``results_path``: ``nomad_avg.csv`` / ``nomad_scores.csv``.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from datetime import datetime

import numpy as np

INDEX_NAME = "Test File"


def file_label(path: str) -> str:
    return path.split("/")[-1].split(".")[0]


@dataclass
class ResultTable:
    """A labelled 2-D table: the port's stand-in for the JAX package's
    DataFrames (rows ``index`` under the name ``index_name``, columns
    ``columns``, ``values``; scores come rounded)."""

    index: list
    columns: list
    values: np.ndarray
    index_name: str = INDEX_NAME

    def rows(self):
        """Header, then one row per index label, as CSV cells."""
        yield [self.index_name] + list(self.columns)
        for label, row in zip(self.index, self.values):
            yield [label] + [_cell(v) for v in row]

    def records(self) -> list[dict]:
        """One dict per row, ``{index_name: label, column: value, ...}`` with
        Python floats: the shape of pandas' ``reset_index().to_dict(
        orient="records")`` of the JAX package's frame."""
        return [{self.index_name: label, **{c: float(v) for c, v in zip(self.columns, row)}}
                for label, row in zip(self.index, self.values)]

    def head(self, n: int = 5) -> str:
        lines = [",".join(map(str, r)) for r in self.rows()]
        return "\n".join(lines[: n + 1])


def _cell(v) -> str:
    # numpy's str of a float32/float64 scalar is the shortest repr that
    # round-trips in that type, as pandas writes it; NaN is an empty cell
    return "" if np.isnan(v) else str(v)


def build_result_tables(
    test_paths, nmr_paths, distance_matrix: np.ndarray
) -> tuple[ResultTable, ResultTable]:
    distance_matrix = np.asarray(distance_matrix)
    avg = np.mean(distance_matrix, axis=1)
    test_labels = [file_label(p) for p in test_paths]
    avg_table = ResultTable(test_labels, ["NOMAD"], np.round(avg, 3)[:, None])
    dm_table = ResultTable(
        test_labels, [file_label(p) for p in nmr_paths], np.round(distance_matrix, 3)
    )
    return avg_table, dm_table


def _write(table: ResultTable, path: str) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, lineterminator="\n").writerows(table.rows())


def write_results(
    avg: ResultTable, dm: ResultTable, results_path: str | None
) -> tuple[str, str]:
    if results_path is None:
        dt_string = datetime.now().strftime("%d-%m-%Y_%H-%M-%S")
        out_dir = os.path.join("results-csv", dt_string)
        os.makedirs(out_dir, exist_ok=True)
        avg_path = os.path.join(out_dir, f"{dt_string}_nomad_avg.csv")
        scores_path = os.path.join(out_dir, f"{dt_string}_nomad_scores.csv")
    else:
        avg_path = os.path.join(results_path, "nomad_avg.csv")
        scores_path = os.path.join(results_path, "nomad_scores.csv")
    _write(avg, avg_path)
    _write(dm, scores_path)
    return avg_path, scores_path
