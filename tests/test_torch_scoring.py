"""The port's scoring path (engine, CSVs, API, CLI, host ingest) against
the JAX package's, on the tiny config with bridged weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nomad_tpu.io as jio
from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.ops.distance import cdist as jax_cdist
from nomad_tpu.scoring import csvio as jcsv
from nomad_tpu.scoring import engine as jengine
import nomad_tpu_torch.api as tapi
import nomad_tpu_torch.io as tio
from nomad_tpu_torch.__main__ import main
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.scoring import csvio as tcsv
from nomad_tpu_torch.scoring import engine as tengine

torch.set_num_threads(2)

EMB = 16


@pytest.fixture(scope="module")
def tiny_params():
    model = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    params = model.init(jax.random.key(1), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Seeded PCM16 wavs of ragged lengths (two buckets), plus one float32
    44.1 kHz stereo file that takes the resampling path."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(11)
    nmr, deg = root / "nmr", root / "deg"
    nmr.mkdir()
    deg.mkdir()
    for i, n in enumerate([3000, 5200, 4100]):
        jio.write_wav(str(nmr / f"ref.{i}.wav"), 0.2 * rng.standard_normal(n), 16000)
    for i, n in enumerate([2500, 4096, 6100, 900, 4500]):
        jio.write_wav(str(deg / f"deg{i}.wav"), 0.3 * rng.standard_normal(n), 16000)
    stereo = 0.25 * rng.standard_normal((2, 7000))
    jio.write_wav(str(deg / "stereo44.wav"), stereo, 44100, bits=32)
    return str(nmr), str(deg)


def test_cli_scores_match_jax(tmp_path, tiny_params, wav_dirs):
    nmr, deg = wav_dirs
    jax_nomad = JaxNomad(config=JaxConfig.tiny(), emb_dim=EMB, params=tiny_params,
                         precision="exact")
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jax_nomad.predict("dir", nmr, deg, str(jdir))
    j_paths = jax_nomad._resolve_paths(nmr), jax_nomad._resolve_paths(deg)
    j_emb = jax_nomad.engine.embed_files(j_paths[0] + j_paths[1])
    j_dm = np.asarray(jax_cdist(j_emb[len(j_paths[0]):], j_emb[: len(j_paths[0])]))

    port = tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                      params=jax_to_state_dict(tiny_params))
    tdir = tmp_path / "port"
    tdir.mkdir()
    tapi._singleton = port
    try:
        main(["--mode", "dir", "--nmr", nmr, "--deg", deg, "--results_path", str(tdir),
              "--device", "cpu"])
    finally:
        tapi._singleton = None
    dm = port.score_matrix(*j_paths)
    assert dm.shape == (6, 3) and np.isfinite(dm).all()
    np.testing.assert_allclose(dm, j_dm, atol=1e-5, rtol=0)

    for name in ("nomad_avg.csv", "nomad_scores.csv"):
        ours = (tdir / name).read_text().splitlines()
        ref = (jdir / name).read_text().splitlines()
        assert len(ours) == len(ref)
        assert ours[0] == ref[0]  # header
        for a, b in zip(ours[1:], ref[1:]):
            ca, cb = a.split(","), b.split(",")
            assert ca[0] == cb[0]  # label (quirk Q2) and row order (Q3)
            np.testing.assert_allclose(np.float64(ca[1:]), np.float64(cb[1:]), atol=1e-3, rtol=0)
    assert "ref" in (tdir / "nomad_scores.csv").read_text().splitlines()[0]


def test_csv_mode_follows_the_csv_rows(tmp_path, tiny_params, wav_dirs):
    """Quirk Q3: csv mode scores the files of each csv's 'filename' column
    in row order; the scores are those of dir mode for the same files."""
    nmr, deg = wav_dirs
    port = tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                      params=jax_to_state_dict(tiny_params))
    avg_dir, dm_dir = port.predict("dir", nmr, deg, str(tmp_path))
    lists, order = {}, {}
    for name, d in (("nmr", nmr), ("deg", deg)):
        files = sorted(os.listdir(d), reverse=True)
        order[name] = [os.listdir(d).index(f) for f in files]  # dir mode: listdir order
        lists[name] = tmp_path / f"{name}.csv"
        lists[name].write_text("filename,other\n" + "".join(f"{d}/{f},x\n" for f in files))
    avg_csv, dm_csv = port.predict("csv", str(lists["nmr"]), str(lists["deg"]), str(tmp_path))
    assert dm_csv.index == [f.split(".")[0] for f in sorted(os.listdir(deg), reverse=True)]
    rows, cols = order["deg"], order["nmr"]
    np.testing.assert_allclose(dm_csv.values, dm_dir.values[rows][:, cols], atol=1e-6, rtol=0)
    np.testing.assert_allclose(avg_csv.values, avg_dir.values[rows], atol=1e-3, rtol=0)
    bad = tmp_path / "bad.csv"
    bad.write_text("path\nx.wav\n")
    with pytest.raises(Exception, match="filename"):
        port.predict("csv", str(bad), str(lists["deg"]), str(tmp_path))


def test_predict_checks_arguments_before_params(tmp_path):
    """Argument errors surface before any weights resolve or model builds."""
    n = tapi.Nomad(device="cpu", weights_dir=str(tmp_path / "nowhere"))
    for args in (("dir", None, "x"), ("dir", "x", None), ("bogus", str(tmp_path), str(tmp_path)),
                 ("dir", str(tmp_path / "missing"), str(tmp_path)),
                 ("dir", str(tmp_path), str(tmp_path), str(tmp_path / "nope"))):
        with pytest.raises(Exception):
            n.predict(*args)
    assert n._model is None
    # the modes build their configs and resolve nothing either; an unknown
    # one raises
    for p in ("balanced", "fast"):
        m = tapi.Nomad(device="cpu", precision=p, weights_dir=str(tmp_path / "nowhere"))
        assert m.config.attn_score_prec == "default" and m._model is None
    with pytest.raises(ValueError, match="unknown precision"):
        tapi.Nomad(device="cpu", precision="turbo")


def test_write_results_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    dm = rng.uniform(0, 2, size=(7, 4)).astype(np.float32)
    dm[0, 0], dm[1, 1], dm[2, 2], dm[3, 3] = 0.0, 1.0, 0.3336, 1.99951
    test = [f"/a/b/t{i}.x.wav" for i in range(7)]
    nmr = [f"/n/ref_{i}.wav" for i in range(4)]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jcsv.write_results(*jcsv.build_result_frames(test, nmr, dm), str(jdir))
    tcsv.write_results(*tcsv.build_result_tables(test, nmr, dm), str(tdir))
    for name in ("nomad_avg.csv", "nomad_scores.csv"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()


def test_batch_plan_matches_jax(tiny_params):
    """What the port's plan still shares with the JAX engine's: the length
    buckets (training's pad target) and the full batch ``prewarm`` warms.
    The port cuts its batches by the files' own lengths (``test_plan_*``)."""
    jeng = jengine.EmbeddingEngine(
        JaxNomadModel(JaxConfig.base(attention_impl="pallas")), params={}
    )
    model = NomadModel(Wav2Vec2Config.tiny())
    model.config = Wav2Vec2Config.base()  # only the config feeds the plan
    teng = tengine.EmbeddingEngine(model, torch.device("cpu"))
    for n in (1, 4096, 4097, 16000, 160000, 163840, 163841, 480000, 1310720):
        assert tengine.bucket_length(n) == jengine.bucket_length(n)
        blen = jengine.bucket_length(n)
        assert teng.batch_size_for(blen) == jeng.batch_size_for(blen)
    assert teng.batch_size_for(163840) == 96
    # the plain attention path caps long buckets by its [B, H, T', T'] buffers
    model.config = Wav2Vec2Config.base(attention_impl="ref")
    assert teng.batch_size_for(1310720) < teng.batch_size_for(163840) == 96


def test_engine_pads_with_last_row_and_keeps_order():
    rng = np.random.default_rng(9)
    model = NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB)
    init_weights(model, seed=1).eval()
    eng = tengine.EmbeddingEngine(model, torch.device("cpu"), batch_sample_budget=4 * 4096)
    waves = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in (900, 3000, 5000, 1200)]
    waves[1] = np.rint(waves[1] * 32768).astype(np.int16)  # the int16 path
    plan = eng.plan([len(w) for w in waves])
    # 4,096 samples: 3 files, no pad row; 8,192: 1 (all 4 at 8,192 pass the budget)
    assert [(len(c), b) for c, b, _ in plan] == [(3, 3), (1, 1)]
    emb = eng.embed_waves(waves)
    with torch.inference_mode():
        for i, w in enumerate(waves):
            x = torch.from_numpy(w.astype(np.float32) / (32768.0 if w.dtype == np.int16 else 1.0))
            np.testing.assert_allclose(emb[i], model(x[None]).numpy()[0], atol=1e-5, rtol=0)


def _bucketed_plan(eng, lengths, groups=None) -> list:
    """The plan the engine had before it planned by lengths (the JAX
    engine's): lengths in buckets of 4 steps an octave, full batches snapped
    to multiples of 32 (powers of two below), tails to a grid; under a mesh
    multiples of the world size. The yardstick of the padding."""
    n = eng.world

    def size(length, remaining=None):
        b = min(max(1, eng.batch_sample_budget // length), tengine.MAX_BATCH,
                eng._attn_batch_cap(length))
        if n is not None:
            b = max(n, (b // n) * n)
            return b if remaining is None or remaining >= b else max(n, -(-remaining // n) * n)
        b = (b // 32) * 32 if b >= 32 else 1 << (b.bit_length() - 1)
        if remaining is not None and remaining < b:
            b = -(-remaining // 32) * 32 if remaining > 32 else 1 << (remaining - 1).bit_length()
        return b

    buckets: dict = {}
    for i in sorted(range(len(lengths)), key=lambda i: lengths[i]):
        key = (tengine.bucket_length(lengths[i]), groups[i] if groups is not None else 0)
        buckets.setdefault(key, []).append(i)
    chunks = []
    for (blen, _), idxs in sorted(buckets.items()):
        while idxs:
            b = min(size(blen, remaining=len(idxs)), size(blen))
            chunks.append((idxs[:b], b, blen))
            idxs = idxs[b:]
    return chunks


def _cell_lengths() -> list:
    """The ``score-corpus`` cell's file lengths, drawn as its mix draws them
    (``benchmark/traffic/audio.py::sizes``, sizes_seed 4321 + group)."""
    groups = ((1000, (1.5, 20.0)), (20, (20.0, 24.0)), (100, (2.0, 4.0)))
    return np.concatenate([
        (np.random.default_rng(4321 + g).uniform(*secs, size=count) * 16000).astype(int)
        for g, (count, secs) in enumerate(groups)]).tolist()


PLAN_CASES = {
    # name: (lengths, groups, sample budget, attention_impl)
    "cell": (_cell_lengths(), None, None, "kernel"),
    "equal": ([160_000] * 300, None, None, "kernel"),
    "one": ([12_345], None, None, "kernel"),
    "single_rows": (np.random.default_rng(1).integers(8_193, 16_385, 9).tolist(), None,
                    4 * 4096, "kernel"),
    "two_rates": (np.random.default_rng(2).integers(2_000, 300_000, 400).tolist(),
                  np.random.default_rng(3).choice([16_000, 44_100], 400).tolist(), None,
                  "kernel"),
    "ref_attention": (np.random.default_rng(4).integers(640_000, 1_280_000, 60).tolist(), None,
                      None, "ref"),
}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_invariants(case, world):
    """The plan by lengths, at each world size (the engine's plan reads
    only the world size): every file in one batch, the limits held, each
    batch as long as its longest file on the grid and padded only to the
    world size, shortest batches first, and never more samples sent than
    the bucketed plan's."""
    lengths, groups, budget, impl = PLAN_CASES[case]
    model = NomadModel(Wav2Vec2Config.tiny())
    model.config = Wav2Vec2Config.base(attention_impl=impl)  # only the config feeds the plan
    eng = tengine.EmbeddingEngine(model, torch.device("cpu"),
                                  batch_sample_budget=budget or tengine.DEFAULT_BATCH_SAMPLE_BUDGET)
    eng.world = None if world == 1 else world
    plan = eng.plan(lengths, groups)
    assert sorted(i for chunk, _, _ in plan for i in chunk) == list(range(len(lengths)))
    for chunk, bsz, blen in plan:
        longest = max(lengths[i] for i in chunk)
        assert blen % tengine.MIN_BUCKET == 0 and longest <= blen < longest + tengine.MIN_BUCKET
        assert bsz % world == 0 and 0 <= bsz - len(chunk) < world
        cap = min(eng.batch_sample_budget // blen, tengine.MAX_BATCH, eng._attn_batch_cap(blen))
        assert bsz <= max(world, cap - cap % world)
        if groups is not None:
            assert len({groups[i] for i in chunk}) == 1
    assert [blen for _, _, blen in plan] == sorted(blen for _, _, blen in plan)
    if case == "ref_attention":  # the attention buffers, not the budget, bind
        assert any(eng._attn_batch_cap(blen) < eng.batch_sample_budget // blen
                   for _, _, blen in plan)
    sent = sum(bsz * blen for _, bsz, blen in plan)
    assert sent <= sum(bsz * blen for _, bsz, blen in _bucketed_plan(eng, lengths, groups))
    if case == "cell" and world == 1:
        assert sent / sum(lengths) <= 1.06


def test_plan_embeds_match_batch1():
    """Batches cut by length, with files either side of grid points, embed
    each file as it embeds alone."""
    rng = np.random.default_rng(11)
    model = NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB)
    init_weights(model, seed=2).eval()
    eng = tengine.EmbeddingEngine(model, torch.device("cpu"), batch_sample_budget=5 * 8192)
    sizes = (8193, 4095, 4097, 8192, 4096, 8191, 12288, 500, 4000, 12289)
    waves = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in sizes]
    plan = eng.plan(sizes)
    assert len(plan) > 1 and any(len(c) > 1 for c, _, _ in plan)
    assert any(len({tengine.bucket_length(sizes[i]) for i in c}) > 1 for c, _, _ in plan)
    emb = eng.embed_waves(waves)
    with torch.inference_mode():
        for i, w in enumerate(waves):
            np.testing.assert_allclose(emb[i], model(torch.from_numpy(w)[None]).numpy()[0],
                                       atol=1e-5, rtol=0)


def test_wav_and_resample_copies_bit_identical(tmp_path):
    rng = np.random.default_rng(3)
    x = np.clip(0.4 * rng.standard_normal((2, 3001)), -1, 1).astype(np.float32)
    for bits in (16, 32):
        a, b = tmp_path / f"j{bits}.wav", tmp_path / f"t{bits}.wav"
        jio.write_wav(str(a), x, 22050, bits=bits)
        tio.write_wav(str(b), x, 22050, bits=bits)
        assert a.read_bytes() == b.read_bytes()
        ja, jsr = jio.read_wav(str(a))
        ta, tsr = tio.read_wav(str(a))
        assert jsr == tsr and ta.dtype == ja.dtype and np.array_equal(ta, ja)
        for sr in (16000, 8000):
            assert np.array_equal(tio.load_processing(str(a), target_sr=sr),
                                  jio.load_processing(str(a), target_sr=sr))
    mono = tmp_path / "m.wav"
    jio.write_wav(str(mono), x[0], 16000)
    assert np.array_equal(tio.read_wav_int16_mono(str(mono))[0], jio.read_wav_int16_mono(str(mono))[0])
    for trim in (False, True):
        assert np.array_equal(tio.load_for_scoring(str(mono), trim=trim),
                              jio.load_for_scoring(str(mono), trim=trim))
    for orig, new in ((44100, 16000), (8000, 16000), (48000, 16000)):
        assert np.array_equal(tio.resample(x, orig, new), jio.resample(x, orig, new))
        for a, b in zip(tio.sinc_resample_kernel(orig, new), jio.sinc_resample_kernel(orig, new)):
            assert np.array_equal(a, b)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"fLaC" + bytes(40))
    # FLAC decodes now: a truncated stream fails as it does in the JAX package
    with pytest.raises(tio.FlacFormatError, match="unexpected end"):
        tio.load_for_scoring(str(bad))
    with pytest.raises(ValueError, match="unexpected end"):
        jio.load_for_scoring(str(bad))
    bad.write_bytes(b"junk" * 10)
    with pytest.raises(tio.UnsupportedAudioError):
        tio.load_for_scoring(str(bad))
