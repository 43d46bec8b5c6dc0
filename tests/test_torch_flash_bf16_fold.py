"""K1b's prologue, held on the CPU: ``fold_bf16_ref``, the plain version of
the kernel that folds k and v to bf16 once per forward call (0 past each
bound), carries all that O and LSE depend on. ``flash_attention_ref`` at
"default" on q and the unfolded folds of k and v gives, bit for bit, what
it gives on the raw k and v with NaN past each bound, f32 and bf16; both
equal the JAX package's Pallas kernel at DEFAULT in interpret mode, as
``tests/test_torch_ops.py`` and ``tests/test_torch_fast_bf16.py`` run it
(XLA on the CPU computes its DEFAULT products in f32, so it is fed the
bf16 values the port's products take: LSE within ``test_torch_ops``' 1e-5,
O within the rounding of P that only the port makes, bounded in float64 as
``test_torch_fast_bf16`` bounds it). Then the check that refuses a
forward workspace not made for q's shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grad_modes import REL_F32, SUM_TOL, bf16_np, rounded_einsum

from nomad_tpu.ops.flash_attention import _mha_pallas_fwd_impl, mha_pallas
from nomad_tpu_torch.ops import flash_attention

torch.set_num_threads(2)
F64 = np.float64


def bf16_ulp(x):
    """One bf16 step at |x| (8 significant bits), as float64."""
    x = np.maximum(np.abs(np.asarray(x, F64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def unfold(folded, b, t, h):
    """[B*H, T64, D] back to [B, T, H, D]."""
    return folded.reshape(b, h, -1, folded.shape[-1])[:, :, :t].transpose(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 50, 64, 65, 129, 499])
def test_folded_kv_carry_all_that_o_and_lse_depend_on(t, dtype):
    rng = np.random.default_rng(1000 + t)
    lengths = [t, max(t // 2, 1), 1, 0]
    b, h, d = len(lengths), 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               .to(getattr(torch, dtype)) for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32)
    k_nan, v_nan = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        k_nan[i, n:] = float("nan")
        v_nan[i, n:] = float("nan")
    folds = [flash_attention.fold_bf16_ref(x, lens, True) for x in (k_nan, v_nan)]
    assert all(f.shape == (b * h, -(-t // 64) * 64, d) for f in folds)
    o_raw, lse_raw = flash_attention.flash_attention_ref(q, k_nan, v_nan, lens, "default")
    o_fold, lse_fold = flash_attention.flash_attention_ref(
        q, *(unfold(f, b, t, h) for f in folds), lens, "default")
    assert o_fold.dtype == q.dtype and torch.isfinite(o_fold).all()
    assert torch.equal(o_fold, o_raw) and torch.equal(lse_fold, lse_raw)

    # the JAX package's kernel on the bf16 values the products take
    qr, kr, vr = (bf16_np(x.float().numpy()).astype(np.float32) for x in (q, k, v))
    jdt = jnp.dtype(dtype)
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    qj, kj, vj = (jnp.asarray(x).astype(jdt) for x in (qr, kr, vr))
    mj = jnp.asarray(mask)
    theirs = np.asarray(jnp.asarray(mha_pallas(qj, kj, vj, mj, interpret=True,
                                               precision=jax.lax.Precision.DEFAULT),
                                    jnp.float32), F64)
    bk = 1 << max(7, (((t + 127) // 128) * 128 - 1).bit_length())  # mha_pallas's blocks
    _, their_lse = _mha_pallas_fwd_impl(qj, kj, vj, mj, bk, bk, True,
                                        precision=jax.lax.Precision.DEFAULT, want_lse=True)
    their_lse = np.asarray(their_lse).reshape(b, h, -1)[:, :, :t]
    # float64: exact attention of the bf16 operands, the same with P rounded
    # to bf16, and the bound on what a P computed in f32 can flip
    s = np.einsum("bqhd,bkhd->bhqk", qr.astype(F64) / 8, kr.astype(F64))
    s = np.where(mask[:, None, None, :], s, -np.inf)
    m = np.max(s, -1, keepdims=True)
    p = np.where(np.isfinite(m), np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    l = np.maximum(p.sum(-1)[..., None], 1e-300)
    vz = np.where(mask[:, :, None, None], vr.astype(F64), 0.0)
    exact = np.einsum("bhqk,bkhd->bqhd", p, vz) / np.moveaxis(l, 1, 2)
    emu, flips = rounded_einsum("bhqk,bkhd->bqhd", p, REL_F32 * p, vz)
    emu, flips = (x / np.moveaxis(l, 1, 2) for x in (emu, flips))
    for o, lse in ((o_raw, lse_raw), (o_fold, lse_fold)):
        ours = o.float().numpy().astype(F64)
        tol = np.abs(emu - exact) + flips + SUM_TOL * np.abs(exact).max()
        if dtype == "bfloat16":  # both outputs rounded once to bf16
            tol = tol + bf16_ulp(np.maximum(np.abs(ours), np.abs(theirs)))
        for i, n in enumerate(lengths):
            if n == 0:  # no key: the port's O = 0, LSE = -1e30
                assert not ours[i].any() and (lse[i] == flash_attention.NEG_INF).all()
                continue
            assert np.all(np.abs(ours[i] - theirs[i]) <= tol[i]), (i, t, dtype)
            np.testing.assert_allclose(lse.numpy()[i], their_lse[i], atol=1e-5, rtol=0)


def _workspace(b, t, h, dtype=torch.bfloat16):
    return torch.zeros((2, b * h, -(-t // 64) * 64, 64), dtype=dtype)


# each a workspace that was not made for q [2, 50, 3, 64]: the kernel would
# read it through a tensor map built from q's shape alone
WRONG_WORKSPACES = {
    "fewer heads": lambda: _workspace(2, 50, 2),
    "longer": lambda: _workspace(2, 65, 3),
    "unpadded": lambda: torch.zeros((2, 6, 50, 64), dtype=torch.bfloat16),
    "in f32": lambda: _workspace(2, 50, 3, torch.float32),
    "strided": lambda: _workspace(2, 50, 6)[:, ::2],
    "k alone": lambda: _workspace(2, 50, 3)[:1],
    "the backward's": lambda: torch.zeros((4, 6, 64, 64), dtype=torch.bfloat16),
    "a tuple": lambda: (_workspace(2, 50, 3),),
}


@pytest.mark.parametrize("case", ["made for q", *WRONG_WORKSPACES])
def test_forward_workspace_must_fit_q(case):
    q = torch.zeros(2, 50, 3, 64)
    if case == "made for q":
        flash_attention._check_flash_bf16_workspace(q, flash_attention._flash_bf16_workspace(q))
        return
    with pytest.raises(ValueError, match="workspace"):
        flash_attention._check_flash_bf16_workspace(q, WRONG_WORKSPACES[case]())
