"""Noisy/clean WAV pairs of the speech-enhancement demo (Valentini-like
utterances): a ``clean`` and a ``noisy`` directory with one file of each
name.

Mix parameters: ``sizes_seed``, ``count``, ``seconds`` [low, high],
``clean_noise``, ``noisy_noise`` [low, high]: the noisy file is the clean
signal plus white noise of an amplitude drawn per pair. Returns
``{"noisy_dir", "clean_dir", "names"}``."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import audio


def make(run, mix: dict) -> dict:
    dirs = {k: run.tmp / k for k in ("noisy", "clean")}
    for d in dirs.values():
        d.mkdir()
    lengths = audio.sizes(mix["sizes_seed"], mix["count"], mix["seconds"])
    order = np.random.default_rng([run.seed, 5]).permutation(mix["count"])
    names = [f"p{i:04d}.wav" for i in range(mix["count"])]

    def one(i):
        rng = np.random.default_rng([run.seed, 6, i])
        n = int(lengths[order[i]])
        clean = audio.speech_like(rng, n, float(mix["clean_noise"]))
        amp = np.float32(rng.uniform(*mix["noisy_noise"]))
        noisy = clean + amp * rng.standard_normal(n, dtype=np.float32)
        audio.write_pcm16(str(dirs["clean"] / names[i]), audio.pcm16(clean))
        audio.write_pcm16(str(dirs["noisy"] / names[i]), audio.pcm16(noisy))

    with ThreadPoolExecutor(audio.THREADS) as ex:
        list(ex.map(one, range(mix["count"])))
    return {"noisy_dir": str(dirs["noisy"]), "clean_dir": str(dirs["clean"]), "names": names}
