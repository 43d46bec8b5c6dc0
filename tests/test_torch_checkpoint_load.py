"""``.pt`` checkpoint loading in the port (``convert/from_fairseq.py``,
``Nomad._resolve_params``) against the JAX package's conversion, on
fairseq-named files the JAX package's ``fairseq_synth`` writes from its HF
oracle (as ``tests/test_fairseq_rehearsal.py`` does), and the port's own
``fairseq_synth``; the weights caches each package writes and the other
reads; ``get_embeddings`` / ``get_embeddings_csv`` against JAX's frames."""

import shutil
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from nomad_tpu.api import CACHE_FILENAME as JAX_CACHE
from nomad_tpu.api import Nomad as JaxNomad
from nomad_tpu.convert import canonicalize as jax_canonicalize
from nomad_tpu.convert import to_flax_params
from nomad_tpu.convert.fairseq_synth import write_fairseq_checkpoint as jax_write_fairseq
from nomad_tpu.convert.fairseq_synth import write_nomad_checkpoint as jax_write_nomad
from nomad_tpu.convert.oracle import TorchNomadOracle
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
import nomad_tpu_torch.api as tapi
from nomad_tpu_torch.convert import (canonicalize, convert_checkpoint, jax_to_state_dict,
                                     load_torch_checkpoint, merge_into)
from nomad_tpu_torch.convert.fairseq_synth import write_fairseq_checkpoint, write_nomad_checkpoint
from nomad_tpu_torch.io import write_wav
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights

torch.set_num_threads(2)
EMB = 16
TOL = 1e-5
LOSSNET = ("lossnet_embedding.weight", "lossnet_embedding.bias")


@pytest.fixture(scope="module")
def oracle():
    return TorchNomadOracle(JaxConfig.tiny(), emb_dim=EMB, seed=3)


@pytest.fixture(scope="module")
def waves():
    rng = np.random.default_rng(0)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (9000, 7200, 11000)]


def weights_dir(tmp_path, name, writer, model, filename):
    d = tmp_path / name
    d.mkdir()
    writer(model, str(d / filename))
    return d


def port_nomad(wdir):
    return tapi.Nomad(device="cpu", config=Wav2Vec2Config.tiny(), emb_dim=EMB,
                      weights_dir=str(wdir))


def jax_nomad(wdir):
    return JaxNomad(config=JaxConfig.tiny(), emb_dim=EMB, weights_dir=str(wdir), precision="exact")


def test_nomad_checkpoint_loads_bit_equal_to_jax_conversion(oracle, waves, tmp_path):
    port_dir = weights_dir(tmp_path, "port", jax_write_nomad, oracle, "nomad_best_model.pt")
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    port, jnp_ = port_nomad(port_dir), jax_nomad(jax_dir)
    sd = port.model.state_dict()
    want = jax_to_state_dict(jnp_.params)
    assert sorted(sd) == sorted(want)
    for k in sd:
        if k not in LOSSNET:  # quirk Q7: each package's own seeded init
            assert torch.equal(sd[k], want[k]), k
    np.testing.assert_allclose(port.engine.embed_waves(waves), jnp_.engine.embed_waves(waves),
                               atol=TOL, rtol=0)
    # both wrote the weights cache; a fresh port loads its own bit-equal
    assert (port_dir / tapi.CACHE_FILENAME).is_file() and (jax_dir / JAX_CACHE).is_file()
    again = port_nomad(port_dir).model.state_dict()
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_each_package_reads_the_others_cache(oracle, waves, tmp_path):
    port_dir = weights_dir(tmp_path, "port", jax_write_nomad, oracle, "nomad_best_model.pt")
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    port_emb = port_nomad(port_dir).engine.embed_waves(waves)
    jax_emb = jax_nomad(jax_dir).engine.embed_waves(waves)
    for d in (port_dir, jax_dir):
        (d / "nomad_best_model.pt").unlink()  # only the caches remain
    # the JAX package reads the port's cache, the port reads the JAX one
    np.testing.assert_allclose(jax_nomad(port_dir).engine.embed_waves(waves), port_emb,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(port_nomad(jax_dir).engine.embed_waves(waves), jax_emb,
                               atol=TOL, rtol=0)
    with np.load(port_dir / tapi.CACHE_FILENAME) as a, np.load(jax_dir / JAX_CACHE) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in b.files)


def test_w2v_checkpoint_warns_and_loads_the_same_backbone(oracle, tmp_path):
    port_dir = weights_dir(tmp_path, "port", jax_write_fairseq, oracle, "wav2vec_small.pt")
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    port = port_nomad(port_dir)
    with pytest.warns(UserWarning, match="scoring head is randomly initialized"):
        sd = port.model.state_dict()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_to_state_dict(jax_nomad(jax_dir).params)
    backbone = [k for k in sd if k.startswith("backbone.")]
    assert len(backbone) == len(sd) - 4
    assert all(torch.equal(sd[k], want[k]) for k in backbone)
    fresh = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=0).state_dict()
    assert torch.equal(sd["embedding.weight"], fresh["embedding.weight"])  # the seeded head


def test_no_checkpoint_warns_and_uses_the_seeded_init(tmp_path):
    with pytest.warns(UserWarning, match="seeded random init"):
        sd = port_nomad(tmp_path / "none").model.state_dict()
    fresh = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=0).state_dict()
    assert all(torch.equal(sd[k], fresh[k]) for k in sd)
    assert not (tmp_path / "none").exists()


def test_port_fairseq_synth_round_trips_and_jax_reads_it(waves, tmp_path):
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=5).eval()
    with torch.no_grad():  # a positional conv whose norm is not 1 at every tap
        model.backbone.encoder.pos_conv.conv.weight.mul_(
            torch.linspace(0.5, 2.0, model.config.pos_conv_kernel))
    want = model.state_dict()
    d = weights_dir(tmp_path, "w", write_nomad_checkpoint, model, "nomad_best_model.pt")
    write_fairseq_checkpoint(model, str(d / "wav2vec_small.pt"))
    for name, head in (("nomad_best_model.pt", True), ("wav2vec_small.pt", False)):
        got = convert_checkpoint(str(d / name), model.config.num_layers,
                                 len(model.config.conv_dim))
        assert sorted(got) == sorted(k for k in want if k not in LOSSNET
                                     and (head or not k.startswith("embedding.")))
        for k, v in got.items():
            if k == "backbone.encoder.pos_conv.conv.weight":  # composed g * v / ||v||
                np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=0)
            else:
                assert torch.equal(v, want[k]), k
        # the JAX package canonicalizes the same names
        raw = load_torch_checkpoint(str(d / name))
        assert sorted(canonicalize(raw)) == sorted(jax_canonicalize(raw))
        to_flax_params(jax_canonicalize(raw), model.config.num_layers, len(model.config.conv_dim))
    (d / "wav2vec_small.pt").unlink()
    jnom = jax_nomad(d)
    np.testing.assert_allclose(jnom.engine.embed_waves(waves),
                               port_nomad(d).engine.embed_waves(waves), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_into(want, {"embedding.weight": torch.zeros(3, 3)})
    with pytest.raises(KeyError, match="not in the model"):
        merge_into(want, {"nope.weight": torch.zeros(3)})


def test_get_embeddings_match_jax_frames(oracle, tmp_path):
    wdir = weights_dir(tmp_path, "w", jax_write_nomad, oracle, "nomad_best_model.pt")
    rng = np.random.default_rng(1)
    files = tmp_path / "files"
    files.mkdir()
    names = []
    for i, n in enumerate((4000, 6500, 3000)):
        names.append(f"f{i}.wav")
        write_wav(str(files / names[-1]), 0.2 * rng.standard_normal(n), 16000, bits=16)
    jnom, port = jax_nomad(wdir), port_nomad(wdir)
    want, got = jnom.get_embeddings(str(files)), port.get_embeddings(str(files))
    assert got.index_name == "filename" == want.columns[0]
    assert got.index == list(want["filename"]) and got.columns == list(want.columns[1:])
    np.testing.assert_allclose(got.values, want.iloc[:, 1:].to_numpy(), atol=TOL, rtol=0)
    series = pd.Series(names, name="filepath_deg")
    want = jnom.get_embeddings_csv(series, root=str(files))
    for file_names in (series, names):
        got = port.get_embeddings_csv(file_names, root=str(files))
        assert got.index == names
        assert got.index_name == ("filepath_deg" if file_names is series else "filename")
        np.testing.assert_allclose(got.values, want.iloc[:, 1:].to_numpy(), atol=TOL, rtol=0)
    rows = list(got.rows())
    assert rows[0] == ["filename"] + list(range(EMB)) and rows[1][0] == names[0]
