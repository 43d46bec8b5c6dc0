"""The port's FLAC codec copies and its native ingest bindings against the
JAX package and the port's own Python path: the decoder bit for bit on
JAX-encoded streams, the encoder's bytes, corrupt streams, the C++ decode
and batch loaders (built here with g++), and the engine scoring a FLAC
file as its WAV twin."""

import numpy as np
import pytest
import torch

import nomad_tpu.io as jio
from nomad_tpu.io import flac as jflac
from nomad_tpu.io import flac_encode as jenc
from nomad_tpu_torch import io as tio
from nomad_tpu_torch.io import flac as tflac
from nomad_tpu_torch.io import flac_encode as tenc
from nomad_tpu_torch.io import native
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.scoring.engine import EmbeddingEngine

torch.set_num_threads(2)

MODES = ["constant", "verbatim", "fixed0", "fixed1", "fixed2", "lpc1", "lpc2"]


def speechy(n, seed=0, amp=3000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (amp * np.sin(2 * np.pi * 220 * t / 16000)
            + amp * 0.3 * np.sin(2 * np.pi * 443 * t / 16000)
            + 50 * rng.standard_normal(n)).astype(np.int64)


def cases():
    """(name, int samples [channels, n], rate, bits, subframe mode)."""
    x = speechy(10000)
    out = [(m, np.zeros((1, 5000), np.int64) if m == "constant" else x[None], 16000, 16,
            "fixed2" if m == "constant" else m) for m in MODES]
    out.append(("non_block_multiple", speechy(4096 * 2 + 777, seed=1)[None], 16000, 16, "fixed2"))
    out.append(("stereo", np.stack([x, (0.6 * x).astype(np.int64)]), 16000, 16, "fixed2"))
    out.append(("stereo_44k_lpc2", np.stack([x, -x // 3]), 44100, 16, "lpc2"))
    out.append(("24bit", (speechy(3000, seed=2, amp=3_000_000))[None], 48000, 24, "fixed1"))
    return out


@pytest.mark.parametrize("name,x,sr,bits,mode", cases(), ids=[c[0] for c in cases()])
def test_encoder_bytes_and_decoder_bits_match_jax(tmp_path, name, x, sr, bits, mode):
    data = jenc.encode_flac(x, sr, bits=bits, subframe_mode=mode)
    assert tenc.encode_flac(x, sr, bits=bits, subframe_mode=mode) == data
    want, wsr, wbits = jflac.decode_flac_bytes(data)
    got, gsr, gbits = tflac.decode_flac_bytes(data)
    assert (gsr, gbits) == (wsr, wbits) == (sr, bits)
    assert got.dtype == want.dtype and np.array_equal(got, want) and np.array_equal(got, x)
    path = str(tmp_path / f"{name}.flac")
    with open(path, "wb") as f:
        f.write(data)
    ja, jsr = jflac.read_flac(path)
    ta, tsr = tio.read_audio(path)  # routed by its magic
    assert tsr == jsr and ta.dtype == ja.dtype and np.array_equal(ta, ja)
    assert np.array_equal(tio.load_processing(path), jio.load_processing(path))


def test_write_flac_and_crc_helpers_match_jax(tmp_path):
    w = np.clip(0.3 * np.random.default_rng(4).standard_normal((2, 7000)), -1, 1)
    tenc.write_flac(str(tmp_path / "t.flac"), w, 16000)
    jenc.write_flac(str(tmp_path / "j.flac"), w, 16000)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    for data in (b"123456789", bytes(range(256))):
        assert tenc.crc8(data) == jenc.crc8(data) and tenc.crc16(data) == jenc.crc16(data)
    assert tenc.crc8(b"123456789") == 0xF4


def _outcome(decode, data):
    try:
        return decode(data)[0]
    except (ValueError, IndexError, MemoryError) as e:
        return type(e).__name__


def test_corrupt_streams_fail_like_jax():
    """Truncated and corrupted streams raise the same exception class in
    both packages (or decode to the same samples)."""
    rng = np.random.default_rng(0)
    good = bytearray(jenc.encode_flac(speechy(5000), 16000))
    inputs = [b"RIFFxxxxWAVE"] + [bytes(good[:cut]) for cut in (10, 50, len(good) // 2,
                                                                len(good) - 3)]
    for _ in range(10):
        bad = bytearray(good)
        for _ in range(20):
            bad[rng.integers(42, len(bad))] = rng.integers(0, 256)
        inputs.append(bytes(bad))
    for data in inputs[:5]:
        with pytest.raises(tflac.FlacFormatError):
            tflac.decode_flac_bytes(data)
    for data in inputs:
        want, got = _outcome(jflac.decode_flac_bytes, data), _outcome(tflac.decode_flac_bytes, data)
        if isinstance(want, str):
            assert got == want
        else:
            assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Mono PCM16 WAVs at 16 kHz, a stereo one, a 22.05 kHz one, and FLAC
    twins (mono and stereo) of two of them."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(5)
    paths = {}
    for name, shape, sr in (("a", (3000,), 16000), ("b", (5200,), 16000),
                            ("st", (2, 4100), 16000), ("r22", (6000,), 22050)):
        w = np.clip(0.3 * rng.standard_normal(shape), -0.99, 0.99).astype(np.float32)
        paths[name] = str(root / f"{name}.wav")
        tio.write_wav(paths[name], w, sr, bits=16)
    for name in ("a", "st"):
        wave, sr = tio.read_wav(paths[name])
        paths[f"{name}_flac"] = str(root / f"{name}_flac.flac")
        tenc.write_flac(paths[f"{name}_flac"], wave, sr)
    return paths


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail(f"the native ingest library did not build: {native.build_error()}")
    return native


def test_native_decode_and_probe_match_python(lib, files):
    for name, path in files.items():
        got, sr = lib.native_decode(path)
        want = tio.load_processing(path, target_sr=sr)[0]
        assert sr == tio.read_audio(path)[1]
        assert got.dtype == np.float32 and np.array_equal(got, want), name
        p_sr, frames, ch, bits, is_float, is_flac = lib.native_probe(path)
        wave, _ = tio.read_audio(path)
        assert (p_sr, frames, ch, bits, is_float, is_flac) == (
            sr, wave.shape[1], wave.shape[0], 16, False, path.endswith(".flac"))
    assert lib.native_probe(str(files["a"]) + ".missing") is None


def test_native_batch_loaders_match_python(lib, files):
    names = ["a", "b", "st", "a_flac", "st_flac"]
    paths = [files[n] for n in names]
    batch, lengths, errs = lib.native_load_batch(paths, pad_len=8192)
    assert (errs == 0).all()
    for row, p in enumerate(paths):
        want = tio.load_processing(p)[0]
        assert lengths[row] == len(want)
        assert np.array_equal(batch[row, : len(want)], want) and not batch[row, len(want):].any()
    # the resampling loader: files at 22.05 kHz, torchaudio's kernel bank
    batch, lengths, errs = lib.native_load_batch([files["r22"]], 16384, expect_sr=22050)
    want = tio.load_processing(files["r22"])[0]
    assert errs[0] == 0 and lengths[0] == len(want)
    np.testing.assert_allclose(batch[0, : len(want)], want, atol=1e-6, rtol=0)
    # the int16 loader writes into the caller's buffer; files it does not
    # take (stereo, FLAC) get an error flag and a zero row
    out = np.full((4, 6000), 7, np.int16)
    lens = np.empty(4, np.int64)
    _, _, errs = lib.native_load_batch_i16([files["a"], files["b"], files["st"], files["a_flac"]],
                                           6000, out=out, lengths=lens)
    assert list(errs[:2]) == [0, 0] and (errs[2:] != 0).all() and not out[2:].any()
    for row, name in enumerate(("a", "b")):
        want = tio.load_for_scoring(files[name])
        assert want.dtype == np.int16 and lens[row] == len(want)
        assert np.array_equal(out[row, : len(want)], want) and not out[row, len(want):].any()
    with pytest.raises(ValueError, match="C-contiguous"):
        lib.native_load_batch_i16([files["a"]], 6000, out=np.zeros((1, 6000), np.float32))


def test_engine_scores_flac_as_its_wav_twin(lib, files):
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=16), seed=2).eval()
    # f32 batches, as the Python path ships them: the default quantizes the
    # stereo and resampled files' batches (tests/test_torch_ingest_q16.py)
    eng = EmbeddingEngine(model, torch.device("cpu"), quantize_transfer=False)
    order = ["a", "a_flac", "st", "st_flac", "b", "r22"]
    emb = eng.embed_files([files[n] for n in order])
    stats = eng.transfer_stats()
    assert stats["native_batches"] == stats["batches"] > 0 and stats["python_batches"] == 0
    np.testing.assert_array_equal(emb[1], emb[0])  # FLAC twin == its WAV
    np.testing.assert_array_equal(emb[3], emb[2])
    # the Python decoder behind it gives the same embeddings
    py = EmbeddingEngine(model, torch.device("cpu")).embed_waves(
        [tio.load_for_scoring(files[n]) for n in order])
    np.testing.assert_allclose(emb, py, atol=1e-6, rtol=0)


class RowStats(torch.nn.Module):
    """Stands in for ``NomadModel`` in the engine: embeds each row of a batch
    as (sum, length, max |x|) of its valid samples."""

    config = Wav2Vec2Config.tiny()
    emb_dim = 3

    def forward(self, wav, lengths):
        mask = torch.arange(wav.shape[1])[None, :] < lengths[:, None]
        x = wav * mask
        return torch.stack([x.sum(1), lengths.to(x.dtype), x.abs().amax(1)], 1)


def test_engine_native_path_orders_rows_as_python(lib, tmp_path, monkeypatch):
    """Files of two buckets and both loaders (int16 for the mono PCM16 WAVs,
    f32 for the batch a FLAC file joins) come back in input order, with the
    rows the Python path gives."""
    rng = np.random.default_rng(6)
    paths = [str(tmp_path / "long.wav"), str(tmp_path / "long.flac"), str(tmp_path / "short.wav")]
    w = np.clip(0.2 * rng.standard_normal(16000 * 10 + 777), -0.99, 0.99).astype(np.float32)
    tio.write_wav(paths[0], w, 16000, bits=16)
    tenc.write_flac(paths[1], w, 16000)
    tio.write_wav(paths[2], w[:5000], 16000, bits=16)
    # a budget of two 10 s rows keeps the short file out of the long files' batch
    budget = 2 * 163_840
    eng = EmbeddingEngine(RowStats(), torch.device("cpu"), batch_sample_budget=budget)
    got = eng.embed_files(paths)
    assert eng.transfer_stats()["native_batches"] == eng.batches == 2
    assert list(got[:, 1]) == [160_777, 160_777, 5000]
    monkeypatch.setattr(native, "available", lambda: False)
    py = EmbeddingEngine(RowStats(), torch.device("cpu"), batch_sample_budget=budget)
    np.testing.assert_array_equal(py.embed_files(paths), got)
    assert py.transfer_stats()["python_batches"] == py.batches == 2
