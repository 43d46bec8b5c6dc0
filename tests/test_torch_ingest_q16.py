"""The port's q16 loader (``native_load_batch(quantize_i16=True)``), the
engine's ``quantize_transfer`` and ``trim`` against the JAX package's, on
22.05 kHz, 44.1 kHz, stereo and FLAC files written here: the loaders'
int16 batches bit for bit, the tiny model's embeddings within 1e-5 (f32
sums in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.io import native as jnative
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.io import native, write_wav
from nomad_tpu_torch.io.flac_encode import write_flac
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config
from nomad_tpu_torch.scoring.engine import EmbeddingEngine, EmbeddingLRU

torch.set_num_threads(2)
EMB = 16
TOL = 1e-5
# BASE's conv strides (320 samples a frame) at tiny widths: 10 s clips give
# T' = 499, a CPU-sized attention
TRIM_CONV = dict(conv_dim=(32, 32, 32), conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8))


def speechy(rng, n, channels=1):
    t = np.arange(n) / 16000
    x = 0.2 * np.sin(2 * np.pi * rng.uniform(90, 250) * t) * np.clip(np.sin(2 * np.pi * t), 0, 1)
    x = x + 0.02 * rng.standard_normal((channels, n))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def write_files(root, rng, seconds):
    """name -> path: mono PCM16 at 16 kHz (the raw int16 loader), 22.05 kHz
    mono, 16 kHz stereo, a 16 kHz FLAC, 44.1 kHz stereo 32-bit PCM."""
    files = {}
    for name, sr, ch, bits in (("m16", 16000, 1, 16), ("r22", 22050, 1, 16),
                               ("st16", 16000, 2, 16), ("fl16", 16000, 1, 16),
                               ("st44", 44100, 2, 32)):
        n = int(seconds[name] * sr)
        x = speechy(rng, n, ch)
        path = str(root / f"{name}.{'flac' if name.startswith('fl') else 'wav'}")
        if name.startswith("fl"):
            write_flac(path, x, sr)
        else:
            write_wav(path, x, sr, bits=bits)
        files[name] = path
    return files


@pytest.fixture(scope="module")
def short_files(tmp_path_factory):
    seconds = {"m16": 0.31, "r22": 0.37, "st16": 0.28, "fl16": 0.33, "st44": 0.26}
    return write_files(tmp_path_factory.mktemp("q16"), np.random.default_rng(4), seconds)


@pytest.fixture(scope="module")
def long_files(tmp_path_factory):
    seconds = {"m16": 10.7, "r22": 11.2, "st16": 10.4, "fl16": 10.9, "st44": 3.1}
    return write_files(tmp_path_factory.mktemp("q16_long"), np.random.default_rng(5), seconds)


def params_for(cfg):
    p = JaxNomadModel(cfg, emb_dim=EMB).init(jax.random.key(2), jnp.zeros((1, 4000)),
                                             method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, p)


def engines(jcfg, tcfg, quantize):
    params = params_for(jcfg)
    jeng = JaxNomad(config=jcfg, emb_dim=EMB, params=params, precision="exact").engine
    jeng.quantize_transfer = quantize
    model = NomadModel(tcfg, emb_dim=EMB)
    model.load_state_dict(jax_to_state_dict(params))
    return jeng, EmbeddingEngine(model.eval(), torch.device("cpu"), quantize_transfer=quantize)


@pytest.mark.parametrize("trim_sec", [0, 1])
def test_q16_loader_bit_equal_to_jax(short_files, trim_sec):
    assert native.available() and jnative.available(), native.build_error()
    for names, expect in ((("r22",), 22050), (("st16", "fl16", "m16"), 0), (("st44",), 44100)):
        paths = [short_files[n] for n in names]
        ours = native.native_load_batch(paths, 8192, 16000, trim_sec, expect_sr=expect,
                                        quantize_i16=True)
        theirs = jnative.native_load_batch(paths, 8192, 16000, trim_sec, expect_sr=expect,
                                           quantize_i16=True)
        assert ours[0].dtype == np.int16
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert not ours[2].any()
        # within 1/65,536 of the f32 loader's samples
        f32 = native.native_load_batch(paths, 8192, 16000, trim_sec, expect_sr=expect)[0]
        assert np.abs(ours[0] / 32768.0 - f32).max() <= 0.5 / 32768 + 1e-9
    # the raw int16 loader's trim, as JAX's
    ours = native.native_load_batch_i16([short_files["m16"]], 8192, 16000, trim_sec)
    theirs = jnative.native_load_batch_i16([short_files["m16"]], 8192, 16000, trim_sec)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize", [True, False])
def test_engine_embeds_like_jax(short_files, quantize):
    """``quantize_transfer`` on (both packages' default: every batch rides
    int16) and off (f32 batches): the port's native engine within 1e-5 of
    the JAX engine."""
    jeng, eng = engines(JaxConfig.tiny(), Wav2Vec2Config.tiny(), quantize)
    paths = list(short_files.values())
    ours = eng.embed_files(paths)
    np.testing.assert_allclose(ours, jeng.embed_files(paths), atol=TOL, rtol=0)
    t = eng.transfer_stats()
    assert t["native_batches"] == t["batches"] and t["python_batches"] == 0
    # off: the mono PCM16 file shares its rate's batch with the others, f32
    assert (t["h2d_bytes_f32"] == 0) == quantize and (t["h2d_bytes_int16"] > 0) == quantize
    assert eng.quantize_transfer == quantize


def test_quantized_embeddings_near_f32(short_files):
    """The quantized batches move the embeddings by no more than the
    PCM16 grid moves the samples, through the model's gain."""
    _, q = engines(JaxConfig.tiny(), Wav2Vec2Config.tiny(), True)
    f = EmbeddingEngine(q.model, torch.device("cpu"), quantize_transfer=False)
    paths = list(short_files.values())
    eq, ef = q.embed_files(paths), f.embed_files(paths)
    d = np.abs(eq - ef).max(axis=1)
    assert d[0] == 0  # the mono PCM16 file rides the raw loader either way
    assert 0 < d.max() < 1e-3


def test_trim_like_jax(long_files, monkeypatch):
    """``trim=True`` keeps each file's first 10 s, through the native
    loaders and through the Python path, as the JAX engine does; the file
    cache keys trim apart."""
    jeng, eng = engines(JaxConfig.tiny(**TRIM_CONV), Wav2Vec2Config.tiny(**TRIM_CONV), True)
    paths = list(long_files.values())
    want = jeng.embed_files(paths, trim=True)
    np.testing.assert_allclose(eng.embed_files(paths, trim=True), want, atol=TOL, rtol=0)
    waves = eng.load_waves(paths, trim=True)
    assert [len(w) for w in waves] == [len(w) for w in jeng.load_waves(paths, trim=True)]
    assert max(len(w) for w in waves) == 160_000
    # the Python path (no native library) on the same files, against JAX's
    # native f32 batches
    monkeypatch.setattr(native, "available", lambda: False)
    py = EmbeddingEngine(eng.model, torch.device("cpu"))
    jeng.quantize_transfer = False
    np.testing.assert_allclose(py.embed_files(paths, trim=True),
                               jeng.embed_files(paths, trim=True), atol=TOL, rtol=0)
    assert py.transfer_stats()["python_batches"] == py.batches
    monkeypatch.undo()
    eng.file_cache = EmbeddingLRU()
    short = eng.embed_files(paths[:1], trim=True)
    full = eng.embed_files(paths[:1])
    assert len(eng.file_cache) == 2 and not np.array_equal(short, full)
    np.testing.assert_array_equal(eng.embed_files(paths[:1], trim=True), short)
    assert eng.cache_hits == 1
