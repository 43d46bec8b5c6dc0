"""The port's graft entry points (``nomad_tpu_torch.graft_entry``)
against the root ``__graft_entry__.py`` of the JAX package: the
single-card forward on bridged weights, and the multi-rank dry run on four
gloo ranks of the CPU."""

import jax
import numpy as np
import torch

import __graft_entry__ as jge
from nomad_tpu_torch import graft_entry
from nomad_tpu_torch.convert import jax_to_state_dict
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config

torch.set_num_threads(2)

# the port's "balanced" embeddings against the JAX package's on the CPU,
# where XLA runs DEFAULT products in f32 (tests/test_torch_precision.py)
TOL_MODE_VS_JAX = 5e-3


def test_graft_entry_matches_jax():
    """``entry(device="cpu")`` on the JAX entry's weights: BASE at the
    "balanced" islands, [2, 256], finite, against JAX's (f32 on the CPU) at
    the modes' tolerance; the same weights and inputs at "exact" against
    JAX at the model tests' 1e-5."""
    jfn, (jparams, jwav, jlengths) = jge.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jwav, jlengths))
    fn, (params, wav, lengths) = graft_entry.entry(device="cpu")
    bridged = jax_to_state_dict(jparams)
    assert sorted(params) == sorted(bridged)
    out = fn(bridged, wav, lengths).numpy()
    assert out.shape == (2, 256) and np.isfinite(out).all()
    np.testing.assert_allclose(out, want, atol=TOL_MODE_VS_JAX, rtol=0)
    exact = NomadModel(Wav2Vec2Config.base(), emb_dim=256)
    exact.load_state_dict(bridged, strict=True)
    with torch.inference_mode():
        np.testing.assert_allclose(exact.eval()(wav, lengths).numpy(), want, atol=1e-5, rtol=0)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    graft_entry.dryrun_multichip(4, device_type="cpu")
    assert "dryrun_multichip OK on 4 cpu ranks" in capsys.readouterr().out
