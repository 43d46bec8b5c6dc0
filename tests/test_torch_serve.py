"""The port's scoring service (``nomad_tpu_torch.serve``) against the JAX
package's, on the tiny config with the same weights carried across the
bridge: the ops' answers, the embedding cache's hits across repeated,
mixed and edited-file requests, errors that leave the service running, the
stats op, and the subprocess entry point whose stdout is JSON only."""

import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.serve import NomadServer as JaxServer
import nomad_tpu_torch.api as tapi
from nomad_tpu_torch import smoke
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.io.flac_encode import write_flac
from nomad_tpu_torch.models import Wav2Vec2Config
from nomad_tpu_torch.scoring.engine import EmbeddingLRU
from nomad_tpu_torch.serve import NomadServer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
EMB = 16
TOL = 1e-5


@pytest.fixture(scope="module")
def tiny_params():
    model = JaxNomadModel(JaxConfig.tiny(), emb_dim=EMB)
    params = model.init(jax.random.key(0), jnp.zeros((1, 800)), method=JaxNomadModel.init_all)
    return jax.tree_util.tree_map(np.asarray, params)


def servers(params, **kw):
    """(JAX server, port server) on the same tiny weights."""
    jax_nomad = JaxNomad(config=JaxConfig.tiny(), emb_dim=EMB, params=params, precision="exact")
    port = tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                      params=jax_to_state_dict(params))
    return JaxServer(nomad=jax_nomad, **kw), NomadServer(nomad=port, **kw)


def roundtrip(server, requests):
    out = io.StringIO()
    server.run(io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n"), out)
    return [json.loads(line) for line in out.getvalue().strip().splitlines()]


def wav(path, n, seed, sr=16000):
    w = (0.2 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    write_wav(str(path), w, sr, bits=16)
    return str(path)


@pytest.fixture()
def tree(tmp_path):
    """nmr/ (3 files) and deg/ (3 WAVs of two buckets and a FLAC file)."""
    nmr, deg = tmp_path / "nmr", tmp_path / "deg"
    nmr.mkdir()
    deg.mkdir()
    for i, n in enumerate((3000, 4100, 5200)):
        wav(nmr / f"n{i}.wav", n, i)
    for i, n in enumerate((2500, 4096, 6100)):
        wav(deg / f"d{i}.wav", n, 10 + i)
    x = (0.2 * np.random.default_rng(20).standard_normal(3500)).astype(np.float32)
    write_flac(str(deg / "f0.flac"), x, 16000)
    return nmr, deg


def test_ping_unknown_op_and_errors_do_not_kill_the_service(tiny_params):
    reqs = [{"op": "ping"}, {"op": "nope"}, {"op": "score", "nmr": "/nope", "deg": "/nope"},
            {"op": "embed"}, {"op": "ping"}]
    jsrv, srv = servers(tiny_params)
    want, got = roundtrip(jsrv, reqs), roundtrip(srv, reqs)
    assert [r["ok"] for r in got] == [r["ok"] for r in want] == [True, False, False, False, True]
    assert got[0] == want[0] == {"ok": True, "op": "ping"}
    assert got[1] == want[1]
    for r in got[2:4]:
        assert set(r) == {"ok", "error", "traceback"}
    assert got[2]["error"] == want[2]["error"] and got[3]["error"] == want[3]["error"]


def test_score_embed_and_loss_match_jax(tiny_params, tree, tmp_path):
    nmr, deg = tree
    out = tmp_path / "res"
    out.mkdir()
    paths = sorted(str(p) for p in deg.iterdir())
    rng = np.random.default_rng(3)
    est, clean = (0.1 * rng.standard_normal((2, 1600))).tolist(), \
        (0.1 * rng.standard_normal((2, 1600))).tolist()
    reqs = [{"op": "score", "nmr": str(nmr), "deg": str(deg), "results_path": str(out)},
            {"op": "embed", "paths": paths},
            {"op": "loss", "estimate": est, "clean": clean}]
    jsrv, srv = servers(tiny_params)
    (jscore, jemb, jloss), (score, emb, loss) = roundtrip(jsrv, reqs), roundtrip(srv, reqs)
    assert score["ok"] and emb["ok"] and loss["ok"]
    for key in ("avg", "pairwise"):
        assert len(score[key]) == len(jscore[key]) == 4
        for ours, theirs in zip(score[key], jscore[key]):
            assert list(ours) == list(theirs)  # the same keys, in the same order
            assert ours["Test File"] == theirs["Test File"]
            for k in list(ours)[1:]:
                assert abs(ours[k] - theirs[k]) <= 1e-3 + 1e-9
    np.testing.assert_allclose(emb["embeddings"], jemb["embeddings"], atol=TOL, rtol=0)
    assert isinstance(loss["loss"], float) and loss["loss"] > 0
    assert abs(loss["loss"] - jloss["loss"]) <= TOL * abs(jloss["loss"])
    # the raw distances behind the rounded records
    nmr_paths = srv.nomad._resolve_paths(str(nmr))
    deg_paths = srv.nomad._resolve_paths(str(deg))
    dm = srv.nomad.score_matrix(nmr_paths, deg_paths)
    j_emb = jsrv.nomad.engine.embed_files(nmr_paths + deg_paths)
    j_dm = np.linalg.norm(j_emb[3:, None, :] - j_emb[None, :3, :], axis=-1)
    np.testing.assert_allclose(dm, j_dm, atol=TOL, rtol=0)
    assert (out / "nomad_avg.csv").is_file() and (out / "nomad_scores.csv").is_file()


def test_cache_hits_match_jax_across_repeated_mixed_and_edited_requests(tiny_params, tree,
                                                                        tmp_path):
    nmr, deg = tree
    score = {"op": "score", "nmr": str(nmr), "deg": str(deg)}
    new = wav(tmp_path / "new.wav", 2000, 30)
    cached = [str(nmr / "n0.wav"), str(deg / "d1.wav")]
    jsrv, srv = servers(tiny_params)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # score without results_path writes results-csv/ here
    try:
        steps = [[score], [score], [{"op": "embed", "paths": cached + [new]}]]
        got, want = [], []
        for reqs in steps:
            got.append(roundtrip(srv, reqs + [{"op": "stats"}]))
            want.append(roundtrip(jsrv, reqs + [{"op": "stats"}]))
        # an edited file (new content and mtime) is embedded again
        wav(deg / "d0.wav", 2700, 40)
        later = time.time_ns() + 10**9
        os.utime(deg / "d0.wav", ns=(later, later))
        got.append(roundtrip(srv, [score, {"op": "stats"}]))
        want.append(roundtrip(jsrv, [score, {"op": "stats"}]))
    finally:
        os.chdir(cwd)
    for ours, theirs in zip(got, want):
        assert ours[-1]["embed_cache"] == theirs[-1]["embed_cache"]
    hits = [g[-1]["embed_cache"]["hits"] for g in got]
    assert hits == [0, 7, 9, 15]
    assert got[-1][-1]["embed_cache"]["stale_evictions"] == 1
    cold, repeat = got[0][0], got[1][0]
    assert repeat["pairwise"] == cold["pairwise"] and repeat["avg"] == cold["avg"]
    assert got[3][0]["pairwise"] != cold["pairwise"]
    # the mixed request embeds its miss alone: held to the padded-vs-batch-1
    # tolerance against a cold engine, not to bits
    mixed = np.asarray(got[2][0]["embeddings"])
    cold_emb = srv.nomad.engine.embed_waves(
        [srv.nomad.engine.load_waves([p])[0] for p in cached + [new]])
    np.testing.assert_allclose(mixed, cold_emb, atol=TOL, rtol=0)


def test_stats_and_warm_ops(tiny_params, tree):
    nmr, deg = tree
    jsrv, srv = servers(tiny_params, cache_size=4)
    paths = sorted(str(p) for p in list(nmr.iterdir()) + list(deg.iterdir()))
    reqs = [{"op": "embed", "paths": paths[i: i + 2]} for i in range(0, len(paths), 2)]
    reqs.append({"op": "stats"})
    got, want = roundtrip(srv, reqs)[-1], roundtrip(jsrv, reqs)[-1]
    assert set(got) == set(want) == {"ok", "stats", "precision", "transfer", "embed_cache"}
    assert got["embed_cache"] == want["embed_cache"]
    assert got["embed_cache"]["entries"] == 4 and got["embed_cache"]["evictions"] == 3
    assert got["precision"] == "custom"
    assert {"engine.submit", "engine.collect", "engine.native_ingest"} <= set(got["stats"])
    t = got["transfer"]
    assert t["batches"] == t["native_batches"] + t["python_batches"] > 0
    # the FLAC file's batch is quantized to int16 in C++ (quantize_transfer)
    assert t["h2d_bytes_int16"] > 0 and t["h2d_bytes_f32"] == 0
    warm = srv.handle({"op": "warm", "seconds": [0.3]})
    assert warm["ok"] and set(warm["warmed_s"]) == {"0.3", "total"}
    assert srv.nomad.engine.batches == t["batches"]  # prewarm counts no batch


def test_embedding_lru_bounds_memory_and_evicts_stale():
    """JAX's soak test on the port's LRU: a churning population holds the
    cache at maxsize, an edited file replaces its stale entry, and a touched
    entry survives the next evictions."""
    lru = EmbeddingLRU(maxsize=64)
    emb = torch.zeros(16)
    for i in range(1000):
        lru[(f"/f/{i}.wav", 1, 100)] = emb
        assert len(lru) <= 64
    assert len(lru) == 64 and lru.evictions == 1000 - 64
    before = len(lru)
    lru[("/f/999.wav", 2, 100)] = emb
    assert len(lru) == before and lru.stale_evictions == 1
    assert ("/f/999.wav", 1, 100) not in lru and ("/f/999.wav", 2, 100) in lru
    hot = ("/f/990.wav", 1, 100)
    _ = lru[hot]
    for i in range(2000, 2000 + 63):
        lru[(f"/f/{i}.wav", 1, 100)] = emb
    assert hot in lru
    assert lru.stats() == {"entries": 64, "maxsize": 64, "evictions": 1000 - 64 + 63,
                           "stale_evictions": 1}


def test_mixed_hit_miss_request_survives_lru_eviction(tiny_params, tmp_path):
    """A request of cached files and >= maxsize new ones: the inserts evict
    the request's own hits, which were read before (JAX's regression: a
    KeyError on the final gather)."""
    _, srv = servers(tiny_params, cache_size=4)
    eng = srv.nomad.engine
    a = wav(tmp_path / "a.wav", 1600, 0)
    ref_a = eng.embed_files([a])[0]
    newfiles = [wav(tmp_path / f"n{i}.wav", 1600, 10 + i) for i in range(5)]
    out = eng.embed_files([a] + newfiles)
    np.testing.assert_array_equal(out[0], ref_a)
    np.testing.assert_array_equal(out[-1], eng.embed_files([newfiles[-1]])[0])
    assert isinstance(eng.file_cache, EmbeddingLRU) and len(eng.file_cache) <= 4


def test_default_device_and_precision_refusals(monkeypatch):
    """No CPU fallback; an unknown precision raises; "balanced" is served
    (the tiny model takes its islands) and ``stats`` reports it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NomadServer(model="tiny")
    for model in ("tiny", "base"):
        with pytest.raises(ValueError, match="unknown precision"):
            NomadServer(model=model, precision="turbo", device="cpu")
    srv = NomadServer(model="tiny", precision="balanced", device="cpu")
    assert srv.nomad.config == Wav2Vec2Config.tiny(posconv_precision="default",
                                                   attn_score_precision="default",
                                                   ffn1_precision="default")
    assert roundtrip(srv, [{"op": "stats"}])[0]["precision"] == "balanced"


def test_protocol_stream_carries_only_json(tmp_path, tree):
    """``python -m nomad_tpu_torch.serve --model tiny --device cpu``: every
    stdout line parses as JSON (the API's banners go to stderr), the
    service answers in order and exits 0 at shutdown."""
    nmr, deg = tree
    reqs = [{"op": "ping"}, {"op": "score", "nmr": str(nmr), "deg": str(deg),
                             "results_path": None},
            {"op": "embed", "paths": [str(nmr / "n0.wav")]}, {"op": "nope"},
            {"op": "stats"}, {"op": "shutdown"}, {"op": "ping"}]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.serve", "--model", "tiny", "--device", "cpu",
         "--warm", "0.5"],
        input="\n".join(json.dumps(q) for q in reqs) + "\n", capture_output=True, text=True,
        timeout=600, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    resps = [json.loads(line) for line in lines]  # raises if a banner leaked
    assert [r["ok"] for r in resps] == [True, True, True, False, True, True]
    assert len(resps[1]["avg"]) == 4 and resps[-1] == {"ok": True, "op": "shutdown"}
    assert resps[4]["embed_cache"]["hits"] == 1 and resps[4]["precision"] == "exact"
    assert "NOMAD running on: cpu" in proc.stderr and "warmed_s" in proc.stderr


def test_smoke_runner_scores_a_directory_pair(tiny_params, tree, tmp_path, monkeypatch):
    nmr, deg = tree
    port = tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                      params=jax_to_state_dict(tiny_params))
    monkeypatch.setattr(tapi, "_singleton", port)
    monkeypatch.chdir(tmp_path)
    avg, scores = smoke.run({"experiment_name": "Test pip"}, str(nmr), str(deg), device="cpu")
    assert avg.values.shape == (4, 1) and scores.values.shape == (4, 3)
    assert list(Path("results-csv").iterdir())


def test_profiling_spans_trace_and_synth_match_jax():
    from nomad_tpu.utils.profiling import Stopwatch as JaxStopwatch
    from nomad_tpu.utils.synth import speech_like as jax_speech_like
    from nomad_tpu_torch.utils import profiling, synth

    ours, theirs = profiling.Stopwatch(), JaxStopwatch()
    for sw in (ours, theirs):
        with sw.span("a", items=10, nbytes=1000):
            time.sleep(0.01)
        with sw.span("a", items=5):
            pass
        with sw.span("b"):
            pass
    got, want = ours.stats(), theirs.stats()
    assert list(got) == list(want) == ["a", "b"]
    assert all(set(got[k]) == set(want[k]) for k in want)
    assert got["a"]["count"] == 2 and got["a"]["total_s"] >= 0.01 and ours.events() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with ours.span("c", items=2):
            torch.ones(8).sum()
    assert [(r["name"], r["parent"], r["items"]) for r in ours.events()] == [("c", None, 2)]
    ours.reset()
    assert ours.stats() == {} and ours.events() == []
    for dtype in (np.int16, np.float32):
        for a, b in zip(synth.speech_like(3, 0.5, dtype=dtype), jax_speech_like(3, 0.5, dtype=dtype)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
