"""Directory scoring with a WavLM Large backbone: ``predict_dir``'s loop
(whole ``Nomad.predict('dir', ...)`` calls back to back, one client) and
its end-to-end metric, on a ``Nomad`` built from
``Wav2Vec2Config.wavlm_large`` at the configuration's widths, with seeded
weights named by ``reference/wavlm.py``. The check compares every call's
raw distance matrix with the WavLM reference's distances and each
returned table with the rounding of its matrix."""

from __future__ import annotations

import numpy as np
import torch

from .. import reference, weights
from ..harness import load_module
from ..reference import wav, wav2vec2 as ref_w2v, wavlm as ref_wavlm
from . import predict_dir, scoring

window, release = predict_dir.window, predict_dir.release


def make_nomad(run, config: dict, sd: dict):
    """``Nomad`` on ``Wav2Vec2Config.wavlm_large`` at the configuration's
    widths and precision, its model loaded from the seeded ``sd``. The
    port's WavLM has no conv bias and its last bucket at 800 frames, as the
    published config: a configuration that says otherwise is refused."""
    from nomad_tpu_torch.api import Nomad
    from nomad_tpu_torch.models import wav2vec2
    from nomad_tpu_torch.models.wav2vec2 import PRECISION_ISLANDS, Wav2Vec2Config

    w = config["wavlm"]
    if w["conv_bias"] or w["max_bucket_distance"] != wav2vec2.MAX_RELATIVE_DISTANCE:
        raise ValueError(f"conv_bias {w['conv_bias']} and max_bucket_distance "
                         f"{w['max_bucket_distance']}: the port's WavLM takes false and "
                         f"{wav2vec2.MAX_RELATIVE_DISTANCE}")
    cfg = Wav2Vec2Config.wavlm_large(
        conv_dim=tuple(w["conv_dim"]), conv_kernel=tuple(w["conv_kernel"]),
        conv_stride=tuple(w["conv_stride"]),
        hidden_size=w["hidden_size"], num_layers=w["num_layers"], num_heads=w["num_heads"],
        ffn_dim=w["ffn_dim"], pos_conv_kernel=w["pos_conv_kernel"],
        pos_conv_groups=w["pos_conv_groups"], layer_norm_eps=w["layer_norm_eps"],
        relative_position_buckets=w["num_buckets"],
        attention_impl=config["attention_impl"], **PRECISION_ISLANDS[config["precision"]])
    nomad = Nomad(device=run.device, config=cfg, emb_dim=config["emb_dim"], params=sd,
                  precision=config["precision"])
    nomad.model  # noqa: B018 - loads the weights onto the device
    return nomad


def setup(run) -> None:
    with run.phase("weights"):
        cfg = run.config
        sd = weights.seeded(ref_wavlm.param_shapes(cfg["wavlm"], cfg["emb_dim"]), run.seed,
                            run.device)
        nomad = make_nomad(run, cfg, sd)
    with run.phase("traffic"):
        corpus = load_module("traffic", run.traffic["kind"]).make(run, run.traffic)
    results = run.tmp / "results"
    results.mkdir()
    run.state.update(sd=sd, nomad=nomad, corpus=corpus, results=str(results),
                     scored=scoring.capture_score_matrix(nomad))
    with run.phase("warmup"):
        predict_dir._call(run)
    run.state["scored"].clear()


def _reference_embeddings(run, paths: list, control: bool) -> dict:
    """path -> the WavLM reference's embedding of the file, one file at a
    time (kept in the run, so that the control reuses the float32 ones)."""
    p, w = run.state["sd"], run.config["wavlm"]
    out = run.state.setdefault(("ref_emb", control), {})
    with reference.precision(tf32=control), torch.no_grad():
        for path in (q for q in paths if q not in out):
            x, _ = wav.read_pcm16(path)
            out[path] = ref_wavlm.embed(p, w, torch.from_numpy(x).to(run.device)[None])[0]
    return out


def dm_gap(run, control: bool) -> float:
    """``scoring.dm_gap`` against the WavLM reference: the widest gap
    between a distance the system computed and the reference's (float64
    distances of float32 embeddings) over every call; with ``control`` the
    reference in TF32 in the system's place. Every file has to have been
    scored."""
    scored, files = run.state["scored"], [p for p, _ in run.state["corpus"]["deg"]]
    nmr = sorted(scored[0][0])
    ref = _reference_embeddings(run, files + nmr, control=False)
    ref_dm = ref_w2v.distances(torch.stack([ref[p] for p in files]),
                               torch.stack([ref[p] for p in nmr])).cpu().numpy()
    if control:
        low = _reference_embeddings(run, files + nmr, control=True)
        got = ref_w2v.distances(torch.stack([low[p] for p in files]),
                                torch.stack([low[p] for p in nmr])).cpu().numpy()
        return float(np.abs(got - ref_dm).max())
    gap, seen = 0.0, set()
    for nmr_paths, test_paths, m in scored:
        rows = {p: i for i, p in enumerate(test_paths)}
        cols = {p: i for i, p in enumerate(nmr_paths)}
        here = [k for k, p in enumerate(files) if p in rows]
        seen.update(here)
        if here:
            got = m[np.ix_([rows[files[k]] for k in here], [cols[p] for p in nmr])]
            gap = max(gap, float(np.abs(got.astype(np.float64) - ref_dm[here]).max()))
    return gap if len(seen) == len(files) else float("inf")


def compare(run, control: bool = False) -> dict:
    st = run.state
    if not st["scored"]:
        return {"dm_gap": float("inf"), "table_gap": float("inf")}
    return {"dm_gap": dm_gap(run, control),
            "table_gap": 0.0 if control else scoring.table_gap(st["scored"], st["tables"])}
