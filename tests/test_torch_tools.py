"""The port's dataset tools against the JAX package's, on seeded inputs:
the BS.1770-4 meter and normalizers (``utils/loudness.py``, 1e-9
relative), the numpy degradations (``utils/degradations.py``: the written
files byte for byte), NSIM triplet sampling (``utils/nsim_sampling.py``:
row for row, on tables with ties) and the degrader drivers
(``utils/degrader_drivers.py``: the CSVs as pandas reads them back, the
degraded files byte for byte). The codec round trips need ffmpeg, which
this machine lacks: their refusal and their absence from the grids are
checked."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from nomad_tpu.io import write_wav as jwrite_wav
from nomad_tpu.utils import degradations as jD
from nomad_tpu.utils import degrader_drivers as jdrv
from nomad_tpu.utils import loudness as jL
from nomad_tpu.utils import nsim_sampling as jnsim
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.training.data import read_table
from nomad_tpu_torch.utils import degradations as D
from nomad_tpu_torch.utils import degrader_drivers as drv
from nomad_tpu_torch.utils import loudness as L
from nomad_tpu_torch.utils import nsim_sampling as nsim

REL = 1e-9


def signal(seed, n, channels=1, amp=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = amp * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
    x = x * np.clip(np.sin(2 * np.pi * t), 0.05, 1)
    return (x + 0.05 * amp * rng.standard_normal((channels, n))).astype(np.float32)


def close(a, b):
    if isinstance(a, float) and not np.isfinite(a):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=REL, atol=0)


@pytest.mark.parametrize("fs", [16000, 44100, 48000])
def test_loudness_meter_matches_jax(fs):
    x = signal(fs, int(1.3 * fs), channels=2)[:, : int(1.3 * fs)]
    close(L.integrated_loudness(x, fs), jL.integrated_loudness(x, fs))
    close(L.integrated_loudness(x[0], fs), jL.integrated_loudness(x[0], fs))
    close(L.true_peak_db(x, fs), jL.true_peak_db(x, fs))
    close(L.k_weight(x, fs), jL.k_weight(x, fs))
    silent = np.zeros(fs // 2, np.float32)
    assert L.integrated_loudness(silent, fs) == jL.integrated_loudness(silent, fs) == -np.inf


@pytest.mark.parametrize("dynamic,amp", [("auto", 0.05), ("auto", 0.9), ("never", 0.9),
                                         ("always", 0.3)])
def test_normalize_loudness_matches_jax(dynamic, amp):
    x = signal(7, 40000, amp=amp)[0]
    x[20000:21000] *= 3.0  # a transient for the limiter
    y, info = L.normalize_loudness(x, 16000, dynamic=dynamic)
    jy, jinfo = jL.normalize_loudness(x, 16000, dynamic=dynamic)
    assert y.dtype == jy.dtype and info.keys() == jinfo.keys()
    close(y, jy)
    for k in info:
        if isinstance(info[k], (bool, str)):
            assert info[k] == jinfo[k], k
        else:
            close(float(info[k]), float(jinfo[k]))


@pytest.fixture()
def wavs(tmp_path):
    paths = {}
    for name, seed, n in (("clean", 1, 16000), ("noise", 2, 5000), ("short", 3, 300)):
        paths[name] = str(tmp_path / f"{name}.wav")
        write_wav(paths[name], signal(seed, n), 16000, bits=16)
    return paths


@pytest.mark.parametrize("op", ["noise", "clip", "reverb"])
def test_degradations_write_the_jax_files(wavs, tmp_path, op):
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "theirs.wav")
    if op == "noise":
        for snr in (0, 12.5):
            y = D.noise(wavs["clean"], wavs["noise"], ours, snr_db=snr)
            jy = jD.noise(wavs["clean"], wavs["noise"], theirs, snr_db=snr)
            assert np.array_equal(y, jy)
            assert open(ours, "rb").read() == open(theirs, "rb").read()
    elif op == "clip":
        for factor in (10, 33):
            assert np.array_equal(D.clip_signal(wavs["clean"], ours, clip_factor=factor),
                                  jD.clip_signal(wavs["clean"], theirs, clip_factor=factor))
            assert open(ours, "rb").read() == open(theirs, "rb").read()
    else:
        for p in (20, 80):
            for src in (wavs["clean"], wavs["short"]):
                assert np.array_equal(D.reverb(src, ours, p=p), jD.reverb(src, theirs, p=p))
                assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_codec_routes_refused_without_ffmpeg(wavs, tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not D.have_ffmpeg() and not jD.have_ffmpeg()
    for codec in (D.mp3, D.opus, D.vorbis):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            codec(wavs["clean"], str(tmp_path / "o.wav"))


def nsim_rows(seed, refs=3, per_ref=40):
    """A ViSQOL-like table: NSIM on a 0.05 grid (ties within a group),
    one duplicated row, one reference of 2 rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(refs):
        for i in range(per_ref if r else 2):
            rows.append({"reference": f"spk/ref{r}.wav", "degraded": f"NOISE/ref{r}_{i}.wav",
                         "nsim": float(np.round(rng.uniform(0.4, 1.0) / 0.05) * 0.05)})
    rows.append(dict(rows[5]))
    return rows


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("seed", [0, 10, 123])
def test_create_triplets_row_for_row(seed, hard):
    rows = nsim_rows(seed)
    ours = nsim.create_triplets(rows, N=5, hard_sampling=hard, seed=seed)
    theirs = jnsim.create_triplets(pd.DataFrame(rows), N=5, hard_sampling=hard, seed=seed)
    assert len(ours) == len(theirs) > 0
    assert ours == theirs.to_dict("records")
    dists = [r["anc_pos_dist"] for r in ours]
    assert len(set(dists)) < len(dists)  # ties did occur


def test_build_triplet_csvs_like_jax(tmp_path):
    for split, seed in (("train", 1), ("valid", 2)):
        pd.DataFrame(nsim_rows(seed, refs=4, per_ref=25)).to_csv(tmp_path / f"{split}_nsim.csv",
                                                                index=False)
    args = [str(tmp_path / f"{s}_nsim.csv") for s in ("train", "valid")]
    ours = nsim.build_triplet_csvs(*args, str(tmp_path / "train.csv"),
                                   str(tmp_path / "valid.csv"), N=3, seed=10)
    jnsim.build_triplet_csvs(*args, str(tmp_path / "jtrain.csv"), str(tmp_path / "jvalid.csv"),
                             N=3, seed=10)
    for mine, jax_csv, rows in (("train.csv", "jtrain.csv", ours[0]),
                                ("valid.csv", "jvalid.csv", ours[1])):
        got, want = pd.read_csv(tmp_path / mine), pd.read_csv(tmp_path / jax_csv)
        pd.testing.assert_frame_equal(got, want)
        assert (tmp_path / mine).read_bytes() == (tmp_path / jax_csv).read_bytes()
        assert len(rows) == len(want) and set(got["db"]) == {1, 2}
        # read back, the rows are pandas' to the bit (its float parser)
        assert read_table(str(tmp_path / mine)) == want.to_dict("records")


def test_read_table_parses_floats_as_pandas(tmp_path):
    """``read_table``'s floats are ``pd.read_csv``'s to the bit, where
    ``float()`` differs in the last place on about a third of them."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.uniform(0, 1, 3000), np.round(rng.uniform(0, 1, 500) / 0.05) * 0.05,
                           rng.standard_normal(500) * 1e5, 10.0 ** rng.uniform(-300, 300, 500)])
    cells = [repr(float(v)) for v in vals] + ["1e-05", "1.5E+3", "-0.0", "007.25", ".5", "5.",
                                              "12345678901234567890.5", "3e400", ""]
    path = tmp_path / "f.csv"
    path.write_text("x\n" + "\n".join(f'"{c}"' if not c else c for c in cells) + "\n")
    ours = np.array([r["x"] for r in read_table(str(path))])
    want = pd.read_csv(path)["x"].to_numpy()
    np.testing.assert_array_equal(ours, want)
    assert np.signbit(ours[cells.index("-0.0")])
    assert sum(float(c) != w for c, w in zip(cells[:-1], want)) > 1000


@pytest.fixture()
def librispeech_tree(tmp_path):
    """tests/test_degrader_drivers.py's miniature tree, seeded."""
    rng = np.random.default_rng(9)
    root = tmp_path / "tree"
    for split in ("train-clean-100-wav", "test-clean-wav"):
        d = root / split / "spk1"
        d.mkdir(parents=True)
        for i in range(2):
            w = np.clip(0.3 * rng.standard_normal(2000), -0.99, 0.99).astype(np.float32)
            jwrite_wav(str(d / f"utt{i}.wav"), w[None], 16000, bits=16)
    (root / "noise_train").mkdir()
    w = np.clip(0.2 * rng.standard_normal(1500), -0.99, 0.99).astype(np.float32)
    jwrite_wav(str(root / "noise_train" / "n0.wav"), w[None], 16000, bits=16)
    return root


def driver_config(root):
    return {
        "root": str(root) + "/", "in_dir_train_wav": "train-clean-100-wav",
        "out_dir_train": "train-degraded", "in_dir_test_wav": "test-clean-wav",
        "out_dir_test": "test-degraded", "sr": 16000, "mp3_train": ["64k"],
        "opus_train": ["64k"], "clip_train": [10, 25], "noise_train": [10],
        "root_noise": str(root), "noise_dir_train": "noise_train",
        "noise_dir_test": "noise_train", "mp3_test": ["64k"], "opus_test": ["64k"],
        "clip_test": [10, 30], "noise_test": [5, 20], "reverb": [20, 80], "vorbis": ["3"],
    }


def test_generators_write_the_jax_trees(librispeech_tree, tmp_path):
    """Both generators on copies of one tree: the same CSVs read back (the
    ViSQOL CSV's absolute paths under each copy's root) and the same bytes
    in every degraded file (normalized by the native meter: no ffmpeg)."""
    assert not D.have_ffmpeg()
    theirs = tmp_path / "jax"
    shutil.copytree(librispeech_tree, theirs)
    ours_rows = drv.generate_training_set(driver_config(librispeech_tree), workers=2)
    test_rows = drv.generate_intensity_test_set(driver_config(librispeech_tree), workers=2,
                                                seed=0)
    jdrv.generate_training_set(driver_config(theirs), workers=2)
    jdrv.generate_intensity_test_set(driver_config(theirs), workers=2, seed=0)
    assert len(ours_rows) == 2 * 3 and len(test_rows) == 6
    assert {r["Degradation"] for r in test_rows} == {"CLIP", "REVERB", "NOISE"}
    for rel in ("train-degraded/degraded_data.csv", "train-degraded/visqol_batch.csv",
                "test-degraded/test_degradation_intensity.csv"):
        got, want = pd.read_csv(librispeech_tree / rel), pd.read_csv(theirs / rel)
        if rel.endswith("visqol_batch.csv"):
            want = want.replace(str(theirs), str(librispeech_tree), regex=True)
        pd.testing.assert_frame_equal(got, want)
    files = sorted(p.relative_to(librispeech_tree)
                   for p in librispeech_tree.glob("*-degraded/*/*.wav"))
    assert len(files) == 12
    for rel in files:
        assert (librispeech_tree / rel).read_bytes() == (theirs / rel).read_bytes(), rel


def test_flac_to_wav_and_subset_copier_like_jax(librispeech_tree, tmp_path):
    from nomad_tpu_torch.io.flac_encode import write_flac

    src = tmp_path / "src"
    (src / "CLEAN").mkdir(parents=True)
    for i in range(3):
        (src / "CLEAN" / f"f{i}.wav").write_bytes(b"x")
    csv = tmp_path / "t.csv"
    pd.DataFrame({"Anchor": ["CLEAN/f0.wav", "OPUS/x.wav"],
                  "Positive": ["CLEAN/f1.wav", "CLEAN/f1.wav"],
                  "Negative": ["MP3/y.wav", "CLEAN/f2.wav"]}).to_csv(csv, index=False)
    copied = drv.copy_referenced_subset([str(csv)], str(src), str(tmp_path / "dst"))
    assert copied == jdrv.copy_referenced_subset([str(csv)], str(src), str(tmp_path / "jdst"))
    assert copied == ["CLEAN/f0.wav", "CLEAN/f1.wav", "CLEAN/f2.wav"]
    flac = str(tmp_path / "a.flac")
    write_flac(flac, signal(4, 22050 // 3)[0], 22050)
    drv.flac_to_wav(flac, str(tmp_path / "a.wav"))
    jdrv.flac_to_wav(flac, str(tmp_path / "ja.wav"))
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "ja.wav").read_bytes()
    wav = str(tmp_path / "loud.wav")
    write_wav(wav, signal(5, 8000, amp=0.02), 16000)
    shutil.copy(wav, tmp_path / "jloud.wav")
    drv.loudness_normalize(wav)
    jdrv.loudness_normalize(str(tmp_path / "jloud.wav"))
    assert open(wav, "rb").read() == (tmp_path / "jloud.wav").read_bytes()
    assert os.path.getsize(wav) > 44
