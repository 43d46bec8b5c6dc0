"""The port's operators (nomad_tpu_torch.ops) against the JAX package's.

Seeded numpy inputs go through both. The JAX side runs its Pallas kernels
in interpret mode on the CPU; the port's wrappers take their plain
versions here, because the tensors lie on the CPU. The kernel-vs-plain
checks on the card are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.distance
import torch

from nomad_tpu.ops import distance as jdist
from nomad_tpu.ops.attention import mha_xla
from nomad_tpu.ops.flash_attention import _mha_pallas_fwd_impl, mha_pallas
from nomad_tpu.ops.layernorm import layer_norm as jax_layer_norm
from nomad_tpu.ops.layernorm import layer_norm_xla
from nomad_tpu_torch.ops import (
    cdist,
    cdist_diag,
    flash_attention,
    flash_attention_ref,
    layer_norm,
    layer_norm_ref,
    layernorm,
    mha,
    mha_ref,
)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------- LayerNorm (kernel K5's plain version) ----------------


@pytest.mark.parametrize("width", [512, 768])
def test_layer_norm_ref_matches_jax(width):
    rng = np.random.default_rng(width)
    x = (3.0 * rng.standard_normal((5, 37, width)) + 1.5).astype(np.float32)
    scale = rng.standard_normal(width).astype(np.float32)
    bias = rng.standard_normal(width).astype(np.float32)
    ours = layer_norm_ref(_t(x), _t(scale), _t(bias)).numpy()
    xla = np.asarray(layer_norm_xla(jnp.asarray(x), scale, bias))
    pallas = np.asarray(
        jax_layer_norm(jnp.asarray(x), scale, bias, impl="pallas", interpret=True)
    )
    # 1e-6 absolute, plus 1e-6 relative: outputs reach |y| ~ 8, where one
    # f32 ulp is 9.5e-7 and the two sums' orders differ
    np.testing.assert_allclose(ours, xla, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ours, pallas, atol=1e-6, rtol=1e-6)


def test_layer_norm_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((7, 64)).astype(np.float32))
    w = _t(rng.standard_normal(64).astype(np.float32))
    b = _t(rng.standard_normal(64).astype(np.float32))
    before = layernorm.launches
    out = layer_norm(x, w, b)
    assert layernorm.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, layer_norm_ref(x, w, b))
    with pytest.raises(ValueError, match="impl"):
        layer_norm(x, w, b, impl="pallas")


# ---------------- flash attention (kernel K1's plain version) ----------------


@pytest.mark.parametrize(
    "t,lengths", [(77, [77, 40, 1]), (200, [131, 200, 64])],
)
def test_flash_attention_ref_matches_pallas(t, lengths):
    """O and LSE against the Pallas kernel on the valid query rows, ragged
    lengths, T not a multiple of 128."""
    rng = np.random.default_rng(t)
    b, h, d = len(lengths), 2, 64
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    o, lse = flash_attention_ref(_t(q), _t(k), _t(v), torch.tensor(lengths, dtype=torch.int32))
    assert o.shape == (b, t, h, d) and lse.shape == (b, h, t)
    ref_o = np.asarray(mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(mask), interpret=True))
    # the same blocks mha_pallas picks for this T, to read its LSE
    bk = 1 << max(7, (((t + 127) // 128) * 128 - 1).bit_length())
    _, ref_lse = _mha_pallas_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        bk, bk, True, want_lse=True,
    )
    ref_lse = np.asarray(ref_lse).reshape(b, h, -1)[:, :, :t]
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(o.numpy()[i, :n], ref_o[i, :n], atol=1e-5, rtol=0)
        np.testing.assert_allclose(lse.numpy()[i, :, :n], ref_lse[i, :, :n], atol=1e-5, rtol=0)


def test_flash_attention_ref_rows_finite_past_the_bound():
    """Every query row is written finite, padded rows included, and a NaN
    in a padded key/value row reaches no output: the contract the model's
    multiplicative re-zeroing relies on."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 50, 2, 64
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    lengths = torch.tensor([30, 0], dtype=torch.int32)
    k[0, 30:] = np.nan
    v[0, 30:] = np.nan
    q[0, 30:] = np.nan
    o, lse = flash_attention_ref(_t(q), _t(k), _t(v), lengths)
    assert torch.isfinite(o[0, :30]).all() and torch.isfinite(o[1]).all()
    assert torch.isfinite(lse[0, :, :30]).all()
    # a row with no valid key: O = 0, LSE = -1e30
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.all(lse[1] == flash_attention.NEG_INF)


def test_mha_ref_matches_mha_xla():
    rng = np.random.default_rng(4)
    b, t, h, d = 2, 45, 4, 16
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(t)[None, :] < np.array([45, 20])[:, None]
    for m in (None, mask):
        ours = mha_ref(_t(q), _t(k), _t(v), None if m is None else _t(m)).numpy()
        ref = np.asarray(mha_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_mha_kernel_path_on_cpu_matches_ref_on_valid_rows():
    rng = np.random.default_rng(5)
    b, t, h, d = 2, 33, 2, 64
    q, k, v = (_t(rng.standard_normal((b, t, h, d)).astype(np.float32)) for _ in range(3))
    mask = torch.arange(t)[None, :] < torch.tensor([33, 12])[:, None]
    before = flash_attention.launches
    out = mha(q, k, v, key_mask=mask, impl="kernel")
    assert flash_attention.launches == before
    ref = mha_ref(q, k, v, mask)
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1, :12], ref[1, :12], atol=1e-5, rtol=0)
    assert torch.isfinite(out).all()


# ---------------- distances ----------------


def test_cdist_matches_jax_and_scipy():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((9, 256)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = rng.standard_normal((5, 256)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ours = cdist(_t(a), _t(b)).numpy()
    exact = scipy.spatial.distance.cdist(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(ours, exact, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, np.asarray(jdist.cdist(a, b)), atol=1e-5, rtol=0)
    diag = cdist_diag(_t(a[:5]), _t(b)).numpy()
    np.testing.assert_allclose(diag, np.asarray(jdist.cdist_diag(a[:5], b)), atol=1e-6, rtol=0)


def test_cdist_zero_distance_is_exact():
    """Identical rows read exactly 0 (the Gram form alone leaves ~1e-4)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((12, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.concatenate([x[:3], rng.standard_normal((2, 256)).astype(np.float32)])
    d = cdist(_t(x), _t(x)).numpy()
    assert np.all(np.diag(d) == 0.0)
    np.testing.assert_allclose(d, d.T, atol=1e-6)
    d2 = cdist(_t(x), _t(y)).numpy()
    assert np.all(d2[[0, 1, 2], [0, 1, 2]] == 0.0)
    exact = scipy.spatial.distance.cdist(x.astype(np.float64), y.astype(np.float64))
    np.testing.assert_allclose(d2, exact, atol=1e-5, rtol=0)
