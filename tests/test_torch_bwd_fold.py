"""K2b/K3b's prologue, held on the CPU: ``fold_bf16_ref``, the plain version
of the kernel that folds q, k, v and dO to bf16 once per backward call,
against the JAX package's own fold (``_fold_args``'s ``prep`` with 64-row
blocks, then ``astype(bfloat16)``) on the same seeded numpy inputs, f32
and bf16: bit-equal on every row below the bound, k's and v's rows past
it 0 (the kernels' products never see them: inside a tensor core 0 * NaN
is NaN), the padding to a multiple of 64 rows 0; and the check that
refuses a workspace not made for q's shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops.flash_attention import _fold_args
from nomad_tpu_torch.ops import flash_attention

torch.set_num_threads(2)

# (T, lengths): one tile, a ragged one, the ring's edges, the 10 s clips
CASES = [(1, [1, 0]), (50, [50, 31, 1, 0]), (64, [64, 63]), (65, [65, 1, 0]),
         (129, [129, 100]), (193, [193, 64, 0]), (499, [499, 249])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,lengths", CASES)
def test_fold_matches_the_jax_fold(t, lengths, dtype):
    rng = np.random.default_rng(t)
    b, h, d = len(lengths), 3, 64
    x = rng.standard_normal((b, t, h, d)).astype(np.float32)
    x[0, 0, 0, :3] = [np.nan, np.inf, -0.0]  # below every bound: carried as they are
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    lens = np.asarray(lengths, np.int32)
    key_mask = jnp.arange(t)[None, :] < jnp.asarray(lens)[:, None]
    prep, jlens, t_pad = _fold_args(jx, jx, jx, key_mask, 64, 64)
    want = np.asarray(prep(jx).astype(jnp.bfloat16))  # [B*H, T64, D]
    nan = np.isnan(want.astype(np.float32))
    want = np.where(nan, 0x7FC0, want.view(np.uint16))  # the bits; NaN as one pattern
    assert t_pad == -(-t // 64) * 64 and list(np.asarray(jlens)) == list(np.repeat(lens, h))
    for past in (False, True):  # q and dO; k and v
        got = flash_attention.fold_bf16_ref(xt, torch.from_numpy(lens), past)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b * h, t_pad, d)
        got_nan = torch.isnan(got).numpy()
        got = np.where(got_nan, 0x7FC0, got.view(torch.int16).numpy().view(np.uint16))
        bound = np.repeat(lens if past else np.full(b, t), h)  # rows kept, per folded row
        for r in range(b * h):
            np.testing.assert_array_equal(got_nan[r, :bound[r]], nan[r, :bound[r]])
            np.testing.assert_array_equal(got[r, :bound[r]], want[r, :bound[r]])
            assert not got[r, bound[r]:].any(), (r, past)  # +0, whatever lay past the bound
        assert not want[:, t:].any()  # the JAX fold pads with zeros as well


def _workspace(b, t, h):
    t_pad = -(-t // 64) * 64
    return (torch.zeros((4, b * h, t_pad, 64), dtype=torch.bfloat16),
            torch.zeros((2, b * h, t_pad), dtype=torch.float32))


# each a workspace that was not made for q [2, 50, 3, 64]: the kernels would
# read it through a tensor map built from q's shape alone
WRONG_WORKSPACES = {
    "shorter": lambda: _workspace(2, 50, 2),
    "longer": lambda: _workspace(2, 65, 3),
    "fold in f32": lambda: (_workspace(2, 50, 3)[0].float(), _workspace(2, 50, 3)[1]),
    "ld in bf16": lambda: (_workspace(2, 50, 3)[0], _workspace(2, 50, 3)[1].bfloat16()),
    "strided": lambda: (_workspace(2, 50, 6)[0][:, ::2], _workspace(2, 50, 3)[1]),
    "fold alone": lambda: _workspace(2, 50, 3)[:1],
}


@pytest.mark.parametrize("case", ["made for q", *WRONG_WORKSPACES])
def test_backward_workspace_must_fit_q(case):
    q = torch.zeros(2, 50, 3, 64)
    if case == "made for q":
        flash_attention._check_bwd_bf16_workspace(q, flash_attention._bwd_bf16_workspace(q))
        return
    with pytest.raises(ValueError, match="workspace"):
        flash_attention._check_bwd_bf16_workspace(q, WRONG_WORKSPACES[case]())
