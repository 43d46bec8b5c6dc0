"""Triplet data pipeline (counterpart of ``nomad_tpu.training.data``), on
the stdlib ``csv`` module.

  * ``read_table`` reads a CSV as pandas' ``read_csv`` types it: a column
    whose cells are all ints holds ints, one whose cells are all numbers
    holds floats (an empty cell is NaN), any other holds strings. Floats
    are parsed as pandas' C parser parses them (``pandas_float``), which
    is not always the correctly rounded value ``float()`` gives;
    ``write_rows`` writes rows back as ``to_csv(index=False)`` does.
  * ``TripletDataset``: columns db, Anchor, Positive, Negative (+ the
    distances); the ``db`` level filter compares parsed values, duplicate
    rows are dropped keeping the first (pandas ``drop_duplicates``), and a
    path is ``root + name``, string concatenation (quirk Q9: configs carry
    the trailing '/'). Items load through ``io.load_processing`` (mono,
    16 kHz, optional 10 s trim).
  * ``collate_triplets`` pads A/P/N to one shared ``bucket_length`` target
    of the batch's longest file; groups on the PCM16 grid ship as int16
    (all three or none), which the train step dequantizes on the device.
  * ``TripletLoader`` shuffles with ``default_rng(seed + epoch)`` and
    decodes the next batch in a thread pool while the device steps; with
    ``pin_memory`` the host batch is pinned for an asynchronous copy.
  * ``PairedAudioDataset``: the SE demo's noisy/clean pairs.
"""

from __future__ import annotations

import csv
import math
import os
import queue
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, fields
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..io import load_processing
from ..scoring.engine import PCM16_SCALE, bucket_length, wave_i16able

_INT = re.compile(r"\s*[-+]?\d+\s*$")
_DECIMAL = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$")
_POW10 = tuple(float(f"1e{k}") for k in range(309))  # the parser's table of literals
_MAX_DIGITS = 17


def pandas_float(text: str) -> float:
    """A decimal cell as pandas' C parser reads it (``precise_xstrtod``, its
    default): the first 17 digits accumulated in a double, one digit at a
    time, then one multiply or divide by a power of ten. "0.9500000000000001"
    reads as 0.95, where ``float()`` keeps the last digit. Other text
    ("nan", "inf") goes to ``float()``."""
    m = _DECIMAL.match(text)
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for c in whole:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(c) - 48)
            digits += 1
        else:
            exponent += 1
    for c in (frac or "")[: _MAX_DIGITS - digits]:
        number = number * 10.0 + (ord(c) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        n = int(exp.lstrip("+-")[:_MAX_DIGITS])
        exponent += -n if exp.startswith("-") else n
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column_values(cells: list) -> list:
    if all(_INT.match(c) for c in cells):
        return [int(c) for c in cells]
    try:
        return [pandas_float(c) if c.strip() else math.nan for c in cells]
    except ValueError:
        return cells


def read_table(path: str) -> list:
    """CSV -> rows as dicts of typed values."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        raw = [r for r in reader if r]
    for n, r in enumerate(raw, 2):
        if len(r) != len(header):
            raise ValueError(f"{path}:{n}: {len(r)} cells under {len(header)} columns")
    columns = [_column_values([r[j] for r in raw]) for j in range(len(header))]
    return [dict(zip(header, vals)) for vals in zip(*columns)]


def write_rows(path: str, columns, rows: list) -> None:
    """Rows (dicts) -> a CSV as pandas' ``to_csv(index=False)`` writes
    it: a header, minimal quoting, '\\n' line ends, floats in their
    shortest repr."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([row[c] for c in columns] for row in rows)


def drop_duplicates(rows: list) -> list:
    """Whole-row duplicates dropped, the first kept, order kept."""
    seen, out = set(), []
    for row in rows:
        key = tuple(row.items())
        if key not in seen:
            seen.add(key)
            out.append(row)
    return out


@dataclass
class TripletBatch:
    anchor: np.ndarray  # [B, T] float32 or int16 (or pinned tensors)
    positive: np.ndarray
    negative: np.ndarray
    lengths_a: np.ndarray  # [B] int32
    lengths_p: np.ndarray
    lengths_n: np.ndarray


class TripletDataset:
    def __init__(self, config: dict, data_mode: str = "train_df", level=None):
        self.config = config
        self.root = config["root"]
        rows = read_table(config[data_mode])
        if level is not None:
            rows = [r for r in rows if r["db"] in level]
        self.rows = drop_duplicates(rows)
        self.trim = bool(config.get("trim", False))

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list:
        return [r[name] for r in self.rows]

    def item_paths(self, index: int) -> tuple[str, str, str]:
        row = self.rows[index]
        # Q9: string concatenation, not os.path.join
        return (self.root + row["Anchor"], self.root + row["Positive"],
                self.root + row["Negative"])

    def load_item(self, index: int):
        return tuple(load_processing(p, trim=self.trim)[0] for p in self.item_paths(index))


def pad_group(waves: Sequence[np.ndarray], pad_to: Optional[int] = None):
    lengths = np.array([len(w) for w in waves], np.int32)
    target = pad_to if pad_to is not None else int(lengths.max())
    out = np.zeros((len(waves), target), np.float32)
    for i, w in enumerate(waves):
        out[i, : len(w)] = w
    return out, lengths


def _group_i16(batch: np.ndarray):
    """int16 of a padded f32 group when every sample sits on the PCM16
    grid (16-bit sources, the training corpus' case): half the bytes to
    the device, dequantized there exactly. The input unchanged otherwise."""
    if wave_i16able(batch):
        return np.rint(batch * PCM16_SCALE).astype(np.int16)
    return batch


def collate_triplets(items, bucket: bool = True) -> TripletBatch:
    """Zero-pad the A/P/N groups to one target: the ``bucket_length`` of
    the batch's longest file (or that length with ``bucket=False``)."""
    a_w, p_w, n_w = zip(*items)
    max_len = max(max(len(w) for w in g) for g in (a_w, p_w, n_w))
    target = bucket_length(max_len) if bucket else max_len
    a, la = pad_group(a_w, target)
    p, lp = pad_group(p_w, target)
    n, ln = pad_group(n_w, target)
    ai, pi, ni = _group_i16(a), _group_i16(p), _group_i16(n)
    if all(x.dtype == np.int16 for x in (ai, pi, ni)):
        a, p, n = ai, pi, ni
    return TripletBatch(a, p, n, la, lp, ln)


def _pinned(batch: TripletBatch) -> TripletBatch:
    return TripletBatch(*(torch.from_numpy(getattr(batch, f.name)).pin_memory()
                          for f in fields(batch)))


class TripletLoader:
    """TripletBatches with seeded shuffling and background prefetch. The
    epoch advances with each pass; ``epoch`` may be set to resume."""

    def __init__(self, dataset: TripletDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, num_threads: int = 6, bucket: bool = True,
                 drop_last: bool = False, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.bucket = bucket
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def batch_indices(self) -> list:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def __iter__(self) -> Iterator[TripletBatch]:
        batches = self.batch_indices()
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue item unless the consumer has gone; False if it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
                    for b in batches:
                        batch = collate_triplets(list(ex.map(self.dataset.load_item, b)),
                                                 bucket=self.bucket)
                        if not put(_pinned(batch) if self.pin_memory else batch):
                            return
                put(None)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)


class PairedAudioDataset:
    """Noisy/clean pairs of the SE demo (reference ``AudioDataset``,
    ``nomad_loss_test.py:158-207``): the noisy directory's files in sorted
    order, each matched by name in the clean directory, cropped or
    zero-padded to ``FIXED_LEN`` samples."""

    FIXED_LEN = 16384

    def __init__(self, noisy_dir: str, clean_dir: str, target_sr: int = 16000):
        self.noisy_dir = noisy_dir
        self.clean_dir = clean_dir
        self.noisy = sorted(os.listdir(noisy_dir))
        self.target_sr = target_sr

    def __len__(self) -> int:
        return len(self.noisy)

    def load_item(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        name = self.noisy[idx]
        clean_path = os.path.join(self.clean_dir, name)
        if not os.path.isfile(clean_path):
            raise AssertionError(f"clean file missing for {name}")
        noisy = load_processing(os.path.join(self.noisy_dir, name), target_sr=self.target_sr)[0]
        clean = load_processing(clean_path, target_sr=self.target_sr)[0]
        return self._fix(noisy), self._fix(clean)

    def _fix(self, w: np.ndarray) -> np.ndarray:
        if len(w) < self.FIXED_LEN:
            return np.pad(w, (0, self.FIXED_LEN - len(w)))
        return w[: self.FIXED_LEN]

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0):
        """(noisy, clean) [B, FIXED_LEN] f32 batches; shuffled with
        ``default_rng(seed)``, decoded in a pool of 8 threads."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        with ThreadPoolExecutor(max_workers=8) as ex:
            for s in range(0, len(idx), batch_size):
                items = list(ex.map(self.load_item, idx[s : s + batch_size]))
                yield np.stack([n for n, _ in items]), np.stack([c for _, c in items])
