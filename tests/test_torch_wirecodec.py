"""The port's wire codec (``nomad_tpu_torch/ops/wirecodec.py``, the C++
packer's binding) against the JAX package's: the same streams and frames
byte for byte, the torch decode bit-equal to JAX's jitted decode and to
the input, and the engine's packed path (``wire_codec="on"``) giving the
raw path's embeddings to the bit. Mirrors ``tests/test_wirecodec.py``."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import wirecodec as jwc
from nomad_tpu_torch.io import native, write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.ops import wirecodec as wc
from nomad_tpu_torch.parallel import data_mesh, mesh as tmesh
from nomad_tpu_torch.scoring.engine import EmbeddingEngine

torch.set_num_threads(2)
rng = np.random.default_rng(0)


def _speech_like(b=2, t=163840):
    tt = np.arange(t) / 16000
    x = 0.1 * np.sin(2 * np.pi * 100 * tt) * np.clip(
        np.sin(2 * np.pi * 0.7 * tt), 0, 1) + 0.001 * rng.standard_normal(tt.shape)
    return np.round(np.clip(np.stack([x * (1 - 0.1 * i) for i in range(b)]), -0.99, 0.99)
                    * 32768).astype(np.int16)


# tests/test_wirecodec.py's cases, drawn in its order
CASES = {
    "speech": _speech_like(),
    "noisy-tone": np.round(np.clip(
        0.1 * np.sin(2 * np.pi * 97 * np.arange(163840) / 16000)
        + 0.02 * rng.standard_normal(163840), -0.99, 0.99) * 32768
    ).astype(np.int16)[None].repeat(3, 0),
    "random": rng.integers(-32768, 32768, (4, 8192), dtype=np.int16),
    "zeros": np.zeros((2, 4096), np.int16),
    "extremes": np.tile(np.array([[-32768, 32767]], np.int16), (1, 2048)),
    "constant": np.full((3, 4096), -1234, np.int16),
}
STREAM_KEYS = ("packed", "widths", "offsets", "firsts")


def torch_decode(rows: np.ndarray, b: int, t: int) -> np.ndarray:
    """The port's device decode (on the CPU here) of a combined frame."""
    return wc.decode_combined(torch.from_numpy(rows.view(np.int32)), b, t).numpy()


def assert_same_encoding(enc, jenc):
    for k in STREAM_KEYS:
        assert enc[k].dtype == jenc[k].dtype and np.array_equal(enc[k], jenc[k]), k
    assert enc["shape"] == jenc["shape"] and enc["nbytes"] == jenc["nbytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_roundtrip_exact_and_equal_to_jax(name):
    arr = CASES[name]
    b, t = arr.shape
    enc, jenc = wc.encode(arr), jwc.encode(arr)
    assert_same_encoding(enc, jenc)
    rows = wc.combined_rows(enc)
    assert rows.dtype == np.uint32 and rows.tobytes() == jwc.combined_rows(jenc).tobytes()
    assert np.array_equal(wc.decode_numpy(enc), arr)
    dec = torch_decode(rows, b, t)
    assert dec.dtype == np.int16 and np.array_equal(dec, arr)
    jdec = np.asarray(jwc.decode_combined_traced(jnp.asarray(rows), b, t))
    assert np.array_equal(dec, jdec)
    # the split stream and side arrays decode the same
    packed = torch.from_numpy(enc["packed"].view(np.int32))
    meta = torch.from_numpy(wc.pack_meta(enc).astype(np.int32))
    assert np.array_equal(wc.decode(packed, meta, b, t).numpy(), arr)


def test_native_numpy_and_pooled_encoders_identical(monkeypatch):
    assert native.available(), native.build_error()
    arr = _speech_like(16, 8192)
    arr[3] = rng.integers(-32768, 32768, 8192)  # a row of the widest blocks
    e_nat = wc.encode(arr)
    stream = native.native_pack_i16(arr)[0]  # encode pads it to its bucket
    assert np.array_equal(stream, e_nat["packed"][: len(stream)])
    monkeypatch.setattr(wc, "native_pack_i16", lambda *a, **k: None)
    e_np = wc.encode(arr)
    with ThreadPoolExecutor(4) as pool:
        e_pool = wc.encode(arr, pool=pool)
    for e in (e_np, e_pool):
        assert_same_encoding(e, e_nat)
    assert_same_encoding(e_nat, jwc.encode(arr))


def test_compression_ratios():
    assert wc.encode(CASES["speech"])["nbytes"] < 0.7 * CASES["speech"].nbytes
    assert wc.encode(CASES["noisy-tone"])["nbytes"] < 0.9 * CASES["noisy-tone"].nbytes
    assert wc.encode(CASES["random"])["nbytes"] > CASES["random"].nbytes
    assert wc.encode(CASES["speech"].astype(np.int32)) is None
    assert wc.encode(CASES["speech"][:, :1000]) is None


def test_pack_bucket_bounded_waste_and_equal_to_jax():
    for n in (1, 5000, 100_000, 1_000_000, 6_600_000, 4097, 65_537):
        b = wc._pack_bucket(n)
        assert b == jwc._pack_bucket(n) and b >= n
        if n >= 16 * wc.MIN_PACK_WORDS:  # above the 16 KB-floor regime
            assert (b - n) / n <= 1.0 / 16 + 1e-9


def test_combined_frame_fuzz_roundtrip():
    """Random shapes and payload classes through encode, the combined frame
    and the torch decode: bit-exact, the frame byte-equal to JAX's, the
    layout as ``meta_rows`` predicts."""
    r = np.random.default_rng(42)
    for trial in range(12):
        b = int(r.integers(1, 12))
        t = int(r.integers(1, 9)) * wc.S
        kind = trial % 4
        if kind == 0:  # speech-ish
            tt = np.arange(t) / 16000
            x = np.round(3000 * np.sin(2 * np.pi * 120 * tt))[None] * (
                1 - 0.05 * np.arange(b)[:, None])
            arr = (x + r.integers(-30, 30, (b, t))).astype(np.int16)
        elif kind == 1:  # random
            arr = r.integers(-32768, 32768, (b, t), dtype=np.int16)
        elif kind == 2:  # constant runs
            arr = np.full((b, t), int(r.integers(-32768, 32767)), np.int16)
        else:  # sparse spikes
            arr = np.zeros((b, t), np.int16)
            idx = r.integers(0, t, size=max(1, t // 100))
            arr[:, idx] = r.integers(-32768, 32768, size=len(idx))
        enc = wc.encode(arr)
        rows = wc.combined_rows(enc)
        assert rows.shape == (len(enc["packed"]) // wc.MIN_PACK_WORDS + wc.meta_rows(b, t),
                              wc.MIN_PACK_WORDS)
        assert rows.tobytes() == jwc.combined_rows(jwc.encode(arr)).tobytes()
        np.testing.assert_array_equal(torch_decode(rows, b, t), arr, err_msg=f"trial {trial}")


@pytest.fixture(scope="module")
def tiny_model():
    return init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=16), seed=3).eval()


def test_engine_packed_path_bit_identical(tiny_model, tmp_path):
    """Waves and files (the native ingest) through the packed path give the
    raw path's embeddings to the bit; the stats count the frames."""
    waves = list(_speech_like(6, 8192))
    raw = EmbeddingEngine(tiny_model, torch.device("cpu"), wire_codec="off")
    packed = EmbeddingEngine(tiny_model, torch.device("cpu"), wire_codec="on",
                             parallel_put_min_bytes=1024)
    np.testing.assert_array_equal(packed.embed_waves(waves), raw.embed_waves(waves))
    stats = packed.transfer_stats()
    assert stats["codec_hits"] == packed.batches >= 1 and stats["codec_skips"] == 0
    assert stats["codec_in_use"] and stats["codec_saved_MB"] >= 0
    raw_stats = raw.transfer_stats()
    assert 0 < stats["h2d_bytes_packed"] < raw_stats["h2d_bytes_int16"]
    assert stats["h2d_bytes_int16"] == 0
    assert raw_stats["codec_hits"] == 0 and not raw_stats["codec_in_use"]
    paths = []
    for i, w in enumerate(waves):
        paths.append(str(tmp_path / f"w{i}.wav"))
        write_wav(paths[-1], w[: 8192 - 700 * i].astype(np.float32) / 32768, 16000, bits=16)
    np.testing.assert_array_equal(packed.embed_files(paths), raw.embed_files(paths))
    assert packed.transfer_stats()["native_batches"] >= 1
    assert packed.transfer_stats()["codec_hits"] == packed.batches


def test_engine_skips_incompressible(tiny_model):
    waves = [rng.integers(-32768, 32768, 8192).astype(np.int16) for _ in range(6)]
    eng = EmbeddingEngine(tiny_model, torch.device("cpu"), wire_codec="on",
                          parallel_put_min_bytes=1024)
    emb = eng.embed_waves(waves)
    assert eng.transfer_stats()["codec_skips"] >= 1 and eng.transfer_stats()["codec_hits"] == 0
    np.testing.assert_array_equal(
        emb, EmbeddingEngine(tiny_model, torch.device("cpu")).embed_waves(waves))
    # under the floor a batch ships raw without an encode: neither hit nor skip
    small = EmbeddingEngine(tiny_model, torch.device("cpu"), wire_codec="on")
    small.embed_waves(waves)
    assert small.transfer_stats()["codec_skips"] == small.transfer_stats()["codec_hits"] == 0


def test_wire_codec_on_refused_under_a_mesh(tiny_model):
    with pytest.raises(ValueError, match="wire_codec"):
        EmbeddingEngine(tiny_model, torch.device("cpu"), wire_codec="sometimes")
    tmesh.init_process_group(0, 1, "cpu")
    try:
        mesh = data_mesh()
        with pytest.raises(ValueError, match="under a mesh"):
            EmbeddingEngine(tiny_model, mesh=mesh, wire_codec="on")
        eng = EmbeddingEngine(tiny_model, mesh=mesh)  # "auto": off, the batches ship raw
        eng.embed_waves(list(_speech_like(2, 8192)))
        assert eng.transfer_stats()["codec_hits"] == 0
        assert not eng.transfer_stats()["codec_in_use"]
    finally:
        tmesh.destroy_process_group()
