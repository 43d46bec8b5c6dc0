"""Offline dataset-generation drivers (counterpart of
``nomad_tpu.utils.degrader_drivers``; the reference code's
``audio_degrader_training.py`` and ``audio_degrader_test.py``), writing
their CSVs with the stdlib ``csv`` module where the JAX module uses pandas,
with the same columns, file names and rows.

  * ``generate_training_set``: every clean WAV x the train grid (MP3 and
    OPUS levels where ffmpeg is present, CLIP, NOISE where there are noise
    files), each output loudness-normalized; ``degraded_data.csv``
    (reference, degraded, condition) and ``visqol_batch.csv`` (absolute
    path pairs) in the output root.
  * ``generate_intensity_test_set``: each (degradation, level) condition,
    VORBIS and REVERB included, on one clean file drawn at random;
    ``test_degradation_intensity.csv`` (filepath_deg, Degradation,
    Condition).
  * ``copy_referenced_subset``: the CLEAN files the triplet CSVs name.

The numpy degradations (noise, clip, reverb) always run; the codec round
trips need ffmpeg and are left out of the grids without it. Jobs fan out
over a process pool of spawned workers, and the draws come from
``random.Random`` in the JAX module's order.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import shutil
import subprocess
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Optional

from ..training.data import read_table, write_rows
from . import degradations as D


def flac_to_wav(in_path: str, out_path: str, sr: int = 16000):
    """A FLAC (or WAV) file -> a PCM16 WAV at ``sr``, with the port's own
    decoder and resampler (the reference needed ffmpeg for this)."""
    from ..io import load_processing, write_wav

    write_wav(out_path, load_processing(in_path, target_sr=sr), sr, bits=16)


def _ffmpeg_loudnorm_two_pass(path: str, sr: int, i=-23.0, tp=-2.0, lra=7.0) -> bool:
    """The ffmpeg-normalize recipe: pass 1 measures (loudnorm
    print_format=json on a null muxer), pass 2 applies the measured values
    with linear=true. False if either pass fails."""
    flt = f"loudnorm=I={i}:LRA={lra}:TP={tp}:print_format=json"
    proc = subprocess.run(["ffmpeg", "-hide_banner", "-i", path, "-af", flt, "-f", "null", "-"],
                          capture_output=True, text=True)
    err = proc.stderr  # the JSON block is the last {...} on stderr
    start = err.rfind("{")
    if start < 0:
        return False
    try:
        m = json.loads(err[start: err.rfind("}") + 1])
    except ValueError:
        return False
    flt2 = (f"loudnorm=I={i}:LRA={lra}:TP={tp}"
            f":measured_I={m['input_i']}:measured_LRA={m['input_lra']}"
            f":measured_TP={m['input_tp']}:measured_thresh={m['input_thresh']}"
            f":offset={m['target_offset']}:linear=true")
    tmp = path + ".norm.wav"
    subprocess.call(["ffmpeg", "-y", "-i", path, "-af", flt2, "-ar", str(sr), tmp],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    if os.path.isfile(tmp):
        os.replace(tmp, path)
        return True
    return False


def loudness_normalize(path: str, sr: int = 16000):
    """EBU R128 two-pass normalize to I = -23 LUFS, TP = -2 dBTP in place
    (the reference's ffmpeg-normalize step on every degraded training
    file): ffmpeg's loudnorm where ffmpeg is present, else the BS.1770-4
    meter and gain of ``utils/loudness.py``."""
    if D.have_ffmpeg() and _ffmpeg_loudnorm_two_pass(path, sr):
        return
    from ..io import read_wav, write_wav
    from .loudness import normalize_loudness

    x, sr_x = read_wav(path)
    y, _info = normalize_loudness(x[0], sr_x)
    write_wav(path, y[None], sr_x)


@dataclass
class DegradeJob:
    kind: str  # MP3 | OPUS | NOISE | CLIP | VORBIS | REVERB
    in_path: str
    out_path: str
    level: object
    noise_path: Optional[str] = None
    sr: int = 16000


def run_job(job: DegradeJob) -> DegradeJob:
    os.makedirs(os.path.dirname(job.out_path), exist_ok=True)
    if job.kind == "MP3":
        D.mp3(job.in_path, job.out_path, bitrate=str(job.level), sr=job.sr)
    elif job.kind == "OPUS":
        D.opus(job.in_path, job.out_path, bitrate=str(job.level), sr=job.sr)
    elif job.kind == "VORBIS":
        D.vorbis(job.in_path, job.out_path, quality=str(job.level), sr=job.sr)
    elif job.kind == "NOISE":
        D.noise(job.in_path, job.noise_path, job.out_path, snr_db=float(job.level), sr=job.sr)
    elif job.kind == "CLIP":
        D.clip_signal(job.in_path, job.out_path, clip_factor=float(job.level), sr=job.sr)
    elif job.kind == "REVERB":
        D.reverb(job.in_path, job.out_path, p=float(job.level), sr=job.sr)
    else:
        raise ValueError(job.kind)
    return job


def _out_name(in_path: str, kind: str, level) -> str:
    stem = os.path.splitext(os.path.basename(in_path))[0]
    return f"{stem}_{kind}_{level}.wav"


def _wavs_under(d: str) -> list:
    found = []
    for dirpath, _dirs, files in os.walk(d):
        found += [os.path.join(dirpath, f) for f in files if f.endswith(".wav")]
    return found


def _noise_files(config: dict, key: str, root: str) -> list:
    noise_dir = os.path.join(config.get("root_noise", root), config.get(key, ""))
    if not os.path.isdir(noise_dir):
        return []
    return sorted(os.path.join(noise_dir, f) for f in os.listdir(noise_dir) if f.endswith(".wav"))


def _pool(workers: int) -> ProcessPoolExecutor:
    # spawned, not forked: a caller may hold threads (the engine's, CUDA's)
    return ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def generate_training_set(config: dict, workers: int = 8, limit: Optional[int] = None) -> list:
    """Walk the clean WAV tree and write the degradations x train-levels
    grid, each output normalized; writes ``degraded_data.csv`` and the
    ViSQOL batch CSV. Returns the rows of the first."""
    root = config["root"]
    in_dir = os.path.join(root, config["in_dir_train_wav"])
    out_root = os.path.join(root, config["out_dir_train"])
    sr = int(config.get("sr", 16000))
    clean_files = sorted(_wavs_under(in_dir))
    if limit:
        clean_files = clean_files[:limit]
    noise_files = _noise_files(config, "noise_dir_train", root)

    rng = random.Random(0)
    jobs = []
    for f in clean_files:
        grid = []
        if D.have_ffmpeg():
            grid += [("MP3", lvl) for lvl in config["mp3_train"]]
            grid += [("OPUS", lvl) for lvl in config["opus_train"]]
        grid += [("CLIP", lvl) for lvl in config["clip_train"]]
        if noise_files:
            grid += [("NOISE", lvl) for lvl in config["noise_train"]]
        for kind, lvl in grid:
            out = os.path.join(out_root, kind, _out_name(f, kind, lvl))
            jobs.append(DegradeJob(kind, f, out, lvl, sr=sr,
                                   noise_path=rng.choice(noise_files) if noise_files else None))

    rows = []
    with _pool(workers) as ex:
        for job in ex.map(run_job, jobs):
            loudness_normalize(job.out_path, sr)
            rows.append({"reference": os.path.relpath(job.in_path, in_dir),
                         "degraded": os.path.relpath(job.out_path, out_root),
                         "condition": f"{job.kind}_{job.level}"})
    write_rows(os.path.join(out_root, "degraded_data.csv"),
               ("reference", "degraded", "condition"), rows)
    # the ViSQOL batch format: reference,degraded absolute paths
    write_rows(os.path.join(out_root, "visqol_batch.csv"), ("reference", "degraded"),
               [{"reference": os.path.join(in_dir, r["reference"]),
                 "degraded": os.path.join(out_root, r["degraded"])} for r in rows])
    return rows


def generate_intensity_test_set(config: dict, workers: int = 8, seed: int = 0) -> list:
    """The degradation-intensity set: every (degradation, level) condition
    on one clean file drawn afresh; writes
    ``test_degradation_intensity.csv`` and returns its rows."""
    root = config["root"]
    in_dir = os.path.join(root, config["in_dir_test_wav"])
    out_root = os.path.join(root, config["out_dir_test"])
    sr = int(config.get("sr", 16000))
    clean_files = _wavs_under(in_dir)
    if not clean_files:
        raise RuntimeError(f"no wavs under {in_dir}")
    rng = random.Random(seed)
    noise_files = _noise_files(config, "noise_dir_test", root)

    grid = []
    if D.have_ffmpeg():
        grid += [("MP3", lvl) for lvl in config["mp3_test"]]
        grid += [("OPUS", lvl) for lvl in config["opus_test"]]
        grid += [("VORBIS", lvl) for lvl in config["vorbis"]]
    grid += [("CLIP", lvl) for lvl in config["clip_test"]]
    grid += [("REVERB", lvl) for lvl in config["reverb"]]
    if noise_files:
        grid += [("NOISE", lvl) for lvl in config["noise_test"]]

    jobs = []
    for kind, lvl in grid:
        f = rng.choice(clean_files)
        out = os.path.join(out_root, kind, _out_name(f, kind, lvl))
        jobs.append(DegradeJob(kind, f, out, lvl, sr=sr,
                               noise_path=rng.choice(noise_files) if noise_files else None))

    rows = []
    with _pool(workers) as ex:
        for job in ex.map(run_job, jobs):
            lvl = job.level
            rows.append({"filepath_deg": os.path.relpath(job.out_path, out_root),
                         "Degradation": job.kind,
                         "Condition": float(lvl) if isinstance(lvl, (int, float))
                         else float(str(lvl).rstrip("k"))})
    write_rows(os.path.join(out_root, "test_degradation_intensity.csv"),
               ("filepath_deg", "Degradation", "Condition"), rows)
    return rows


def copy_referenced_subset(csv_paths: list, src_root: str, dst_root: str) -> list:
    """Copy the CLEAN files the triplet CSVs name into a tree of their own
    (the reference's ``librispeechdeg_subset.py``); returns their names."""
    names = set()
    for p in csv_paths:
        for row in read_table(p):
            names.update(str(row[col]) for col in ("Anchor", "Positive", "Negative")
                         if col in row and str(row[col]).startswith("CLEAN"))
    copied = []
    for rel in sorted(names):
        src = os.path.join(src_root, rel)
        dst = os.path.join(dst_root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isfile(src):
            shutil.copyfile(src, dst)
            copied.append(rel)
    return copied
