"""The port's backbone, heads and weight bridge against the JAX package.

The JAX model runs with its Pallas flash-attention and LayerNorm kernels
(interpret mode on the CPU); its parameters go through the bridge into the
port, and both take the same seeded padded batch with per-item lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.api import _flatten
from nomad_tpu.models import NomadModel as JaxNomadModel
from nomad_tpu.models import Wav2Vec2Config as JaxConfig
from nomad_tpu.models import feature_frame_lengths as jax_frame_lengths
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.models import (
    NomadModel,
    Wav2Vec2Config,
    feature_frame_lengths,
    init_weights,
    masked_mean,
)

torch.set_num_threads(2)

EMB = 16
LENGTHS = [1900, 1333, 800]


@pytest.fixture(scope="module")
def bridged():
    """JAX tiny model on the Pallas path, its params, the same batch for
    both packages and the port model loaded through the bridge."""
    jcfg = JaxConfig.tiny(attention_impl="pallas", layernorm_impl="pallas")
    jmodel = JaxNomadModel(jcfg, emb_dim=EMB)
    rng = np.random.default_rng(0)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    lengths = np.asarray(LENGTHS, np.int32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(wav[:1, :800]),
                         method=JaxNomadModel.init_all)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB)
    model.load_state_dict(jax_to_state_dict(params), strict=True)
    model.eval()
    return jmodel, params, model, wav, lengths


def test_layers_and_embedding_match_jax(bridged):
    jmodel, params, model, wav, lengths = bridged
    j_layers = jmodel.apply(params, jnp.asarray(wav), jnp.asarray(lengths),
                            method=JaxNomadModel.forward_layers)
    j_emb = np.asarray(jmodel.apply(params, jnp.asarray(wav), jnp.asarray(lengths)))
    with torch.inference_mode():
        t_wav, t_len = torch.from_numpy(wav), torch.from_numpy(lengths).long()
        layers = model.forward_layers(t_wav, t_len)
        emb = model(t_wav, t_len).numpy()
    cfg = model.config
    assert len(layers) == len(j_layers) == cfg.num_layers + 1
    frames = feature_frame_lengths(lengths, cfg)
    for i in range(cfg.num_layers):
        ours, ref = layers[i].numpy(), np.asarray(j_layers[i])
        assert ours.shape == ref.shape
        for b, n in enumerate(frames):
            np.testing.assert_allclose(ours[b, :n], ref[b, :n], atol=1e-5, rtol=0)
            assert np.all(ours[b, n:] == 0)  # padded frames re-zeroed
    np.testing.assert_allclose(layers[-1].numpy(), np.asarray(j_layers[-1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(emb, j_emb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)


def test_padded_batch_equals_batch_one(bridged):
    _, _, model, wav, lengths = bridged
    with torch.inference_mode():
        batch = model(torch.from_numpy(wav), torch.from_numpy(lengths).long())
        for i, n in enumerate(lengths):
            alone = model(torch.from_numpy(wav[i : i + 1, :n]))
            torch.testing.assert_close(batch[i : i + 1], alone, atol=1e-5, rtol=0)


def test_bridge_flat_and_nested_agree(bridged):
    _, params, model, _, _ = bridged
    nested = jax_to_state_dict(params)
    flat = jax_to_state_dict(_flatten(params["params"]))
    assert nested.keys() == flat.keys() == model.state_dict().keys()
    for k in nested:
        assert torch.equal(nested[k], flat[k]), k
    # a missing leaf is refused by the strict load
    del flat["backbone.encoder.layers.0.fc1.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB).load_state_dict(flat, strict=True)


def test_frame_lengths_and_masked_mean_match_jax():
    from nomad_tpu.models import masked_mean as jax_masked_mean

    for cfg, jcfg in ((Wav2Vec2Config.tiny(), JaxConfig.tiny()),
                      (Wav2Vec2Config.base(), JaxConfig.base())):
        n = np.array([400, 401, 16000, 160000, 163840])
        assert list(feature_frame_lengths(n, cfg)) == list(jax_frame_lengths(n, jcfg))
    assert feature_frame_lengths(163840, Wav2Vec2Config.base()) == 511
    x = np.random.default_rng(2).standard_normal((3, 10, 4)).astype(np.float32)
    lens = np.array([10, 4, 1])
    for ln in (None, lens):
        ours = masked_mean(torch.from_numpy(x), None if ln is None else torch.from_numpy(ln))
        ref = jax_masked_mean(jnp.asarray(x), None if ln is None else jnp.asarray(ln))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_seeded_init_is_deterministic():
    a = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=3).state_dict()
    b = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_config_rejects_unknown_impl():
    with pytest.raises(ValueError, match="attention_impl"):
        Wav2Vec2Config.tiny(attention_impl="pallas")


def test_identical_rows_embed_to_the_same_bits_under_three_threads():
    """A file's embedding does not depend on its row in the batch: two
    identical rows give the same bits under ``torch.set_num_threads(3)``.
    The positional conv's SamePad trim is made contiguous before GELU; on
    a strided view torch's CPU GELU split the rows between its vector and
    scalar paths unevenly, and the rows differed by ~5e-8."""
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(), emb_dim=EMB), seed=2).eval()
    wave = (0.2 * np.random.default_rng(3).standard_normal(3000)).astype(np.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        with torch.inference_mode():
            emb = model(torch.from_numpy(np.stack([wave, wave])), torch.tensor([3000, 3000]))
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(emb[0], emb[1])
