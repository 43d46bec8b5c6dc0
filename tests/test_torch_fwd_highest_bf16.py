"""The "highest" attention forward on bf16 tensors on the CPU: K1-bf16
(``csrc/flash_attention_bf16.cu`` with three planes of P) and K4-bf16
(``csrc/fused_attention_bf16.cu`` at six passes).

(1) A pass model of each kernel written here, on seeded bf16 inputs:
K1-bf16's S in f32 from the bf16 operands (exact products), an online
softmax over 64-key tiles, each tile's P scaled by ``SPLIT3_SCALE``, split
into three bf16 planes and its three plane products with V summed apart
in f32; K4-bf16's projections from three planes of the scaled weights
(each 64-wide slice of the model axis summed apart), Q, K and V split
into three planes, S and P . V in the six passes of XLA's bf16 x 6
decomposition of HIGHEST. Each model lies within 1e-6 of max |O| of the
plain version at "highest" (``flash_attention_ref``,
``fused_qkv_attention_ref``: f32 products of the upcast inputs), and no
further from the JAX package's kernel at HIGHEST in interpret mode
(``mha_pallas``; ``_fused_call`` and the sublayer
``fused_qkv_attention(mode="highest")``) than that plain version is, plus
1e-6 of max |O|. The planes lose nothing and the dropped terms of the six
passes are under 2^-24 relative, so what is left is f32 summation order.
(2) ``pack_weights_ref`` at three planes sums to the scaled weights
exactly. (3) The launch plans at "highest" on bf16 and the wrappers'
routing rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import fused_attention as jfa
from nomad_tpu.ops.flash_attention import mha_pallas
from nomad_tpu_torch.ops import flash_attention, fused_attention, precision

torch.set_num_threads(2)
H, HD = 2, 64
DM = H * HD
TILE = 64  # keys of the kernels' tiles; model-axis values of K4-bf16's ring stages
BF16 = torch.bfloat16
HIGHEST = jax.lax.Precision.HIGHEST
PASS_MODEL_REL = 1e-6  # f32 sums in other orders, relative to max |O|
SCALE = precision.SPLIT3_SCALE
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SMEM_PER_SM, SMEM_RESERVED = 228 * 1024, 1024
TS = [1, 63, 64, 65, 129]


def _edge_lengths(t):
    """A full, a ragged, a 1-key and a 0-key row."""
    return [t, max(t // 2, 1), 1, 0]


def _planes(x):
    """x times SPLIT3_SCALE in its three bf16 planes (hi, mid, lo), as f32."""
    return precision.split3_bf16(x * SCALE)


def _six(a, b, eq):
    """einsum(eq, a, b) of f32 a and b in the six passes of XLA's bf16 x 6
    (mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi, the kernels' order), each
    operand scaled by SPLIT3_SCALE and split, summed in f32, unscaled."""
    pa, pb = _planes(a), _planes(b)
    part = None
    for i, j in ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)):
        term = torch.einsum(eq, pa[i], pb[j])
        part = term if part is None else part + term
    return part / (SCALE * SCALE)


def _three(p, v, eq):
    """einsum(eq, p, v) of f32 p and the bf16 values v: p scaled and split
    into three planes, one f32 product a plane (lo, mid, hi), summed in f32,
    unscaled."""
    part = None
    for plane in reversed(_planes(p)):
        term = torch.einsum(eq, plane, v)
        part = term if part is None else part + term
    return part / SCALE


def _attend(s_of, pv_of, n, t):
    """The kernels' key loop for one (batch row, head) with n valid keys:
    s_of(key slice) the tile's scores [T, keys] in f32, pv_of(p, key slice)
    the tile's P . V [T, 64]; an online softmax over 64-key tiles (tiles
    wholly past the bound skipped), each tile's P . V added to O's sum once
    it is complete. Returns (O [T, 64], LSE [T]) in f32."""
    m = torch.full((t,), flash_attention.NEG_INF)
    l = torch.zeros(t)
    acc = torch.zeros(t, HD)
    for k0 in range(0, n, TILE):
        keys = slice(k0, min(k0 + TILE, n))
        s = s_of(keys)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[:, None] + pv_of(p, keys)
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, flash_attention.NEG_INF))
    return acc * inv[:, None], lse


def k1_pass_model(q, k, v, lengths):
    """K1-bf16's arithmetic in f32 on the CPU for bf16 q, k, v [B, T, H,
    64]: (O [B, T, H, 64], LSE [B, H, T]), f32."""
    b, t, h, d = q.shape
    o = torch.zeros(b, t, h, d)
    lse = torch.full((b, h, t), flash_attention.NEG_INF)
    qf = q.float() * (1.0 / d**0.5)  # exact: q is bf16
    for i in range(b):
        n = int(lengths[i])
        for j in range(h):
            qq, kk, vv = qf[i, :, j], k[i, :, j].float(), v[i, :, j].float()
            o[i, :, j], lse[i, j] = _attend(
                lambda keys: qq @ kk[keys].T,
                lambda p, keys: _three(p, vv[keys], "qk,kd->qd"), n, t)
    return o, lse


def k4_pass_model(x, params, lengths):
    """K4-bf16's arithmetic in f32 on the CPU for a bf16 x [B, T, DM] and the
    f32 (w [out, in], bias) of q, k, v: O head-major [B, H, T, 64], f32."""
    b, t, dm = x.shape
    xf = x.float()
    proj = []
    for w, bias in zip(params[0::2], params[1::2]):
        planes = _planes(w)  # [out, in] each; x is bf16, so every product is exact
        y = torch.zeros(b, t, dm)
        for c0 in range(0, dm, TILE):
            cols = slice(c0, c0 + TILE)
            part = None
            for plane in reversed(planes):
                term = xf[:, :, cols] @ plane[:, cols].T
                part = term if part is None else part + term
            y = y + part
        proj.append((y / SCALE + bias).view(b, t, H, HD))
    q, k, v = proj
    q = q * (1.0 / HD**0.5)
    valid = torch.arange(t)[None, :] < lengths.long()[:, None]
    k = torch.where(valid[:, :, None, None], k, 0.0)
    v = torch.where(valid[:, :, None, None], v, 0.0)
    o = torch.zeros(b, H, t, HD)
    for i in range(b):
        n = int(lengths[i])
        for j in range(H):
            qq, kk, vv = q[i, :, j], k[i, :, j], v[i, :, j]
            o[i, j], _ = _attend(lambda keys: _six(qq, kk[keys], "qd,kd->qk"),
                                 lambda p, keys: _six(p, vv[keys], "qk,kd->qd"), n, t)
    return o


def _tol(ref):
    return PASS_MODEL_REL * ref.abs().max().item()


@pytest.mark.parametrize("t", TS)
def test_k1_bf16_pass_model_matches_the_plain_version_and_mha_pallas(t):
    """On seeded bf16 q, k, v with a full, a ragged, a 1-key and a 0-key
    row, K1-bf16's pass model lies within 1e-6 of max |O| of
    ``flash_attention_ref(..., "highest")`` on the upcast inputs (LSE
    within 1e-6 of max(1, |LSE|)), and no further from the JAX package's
    ``mha_pallas`` forward at HIGHEST in interpret mode than the plain
    version is, plus 1e-6 of max |O| (the JAX kernel leaves the 0-key row
    undefined: the model and the plain version give it O = 0 and LSE =
    -1e30). The plain version on the bf16 tensors is the f32 one rounded
    once, as the kernel's O is."""
    rng = np.random.default_rng(600 + t)
    lengths = _edge_lengths(t)
    b = len(lengths)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, H, HD)).astype(np.float32)).to(BF16)
               for _ in range(3))
    up = [x.float() for x in (q, k, v)]
    lens = torch.tensor(lengths, dtype=torch.int32)
    o, lse = k1_pass_model(q, k, v, lens)
    ref, ref_lse = flash_attention.flash_attention_ref(*up, lens, "highest")
    ref_b, ref_lse_b = flash_attention.flash_attention_ref(q, k, v, lens, "highest")
    assert ref_b.dtype == BF16 and torch.equal(ref_b, ref.to(BF16))
    assert torch.equal(ref_lse_b, ref_lse)
    tol = _tol(ref)
    assert (o - ref).abs().max().item() <= tol
    assert ((lse - ref_lse).abs() <= PASS_MODEL_REL * ref_lse.abs().clamp_min(1.0)).all()
    assert not o[3].any() and (lse[3] == flash_attention.NEG_INF).all()
    mask = jnp.asarray(np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    jx = torch.from_numpy(np.array(mha_pallas(*(jnp.asarray(x.numpy()) for x in up), mask,
                                              interpret=True, precision=HIGHEST)))
    rows = slice(0, 3)
    plain_gap = (ref[rows] - jx[rows]).abs().max().item()
    assert (o[rows] - jx[rows]).abs().max().item() <= plain_gap + tol


def _fused_inputs(t, seed):
    rng = np.random.default_rng(seed)
    lengths = _edge_lengths(t)
    x = rng.standard_normal((len(lengths), t, DM)).astype(np.float32)
    wb = [((rng.standard_normal((DM, DM)) / DM**0.5).astype(np.float32),
           (0.1 * rng.standard_normal(DM)).astype(np.float32)) for _ in range(4)]
    xb = torch.from_numpy(x).to(BF16)
    return xb, wb, lengths


@pytest.mark.parametrize("t", TS)
def test_k4_bf16_pass_model_matches_the_plain_version_and_the_jax_kernel(t):
    """On a seeded bf16 x (2 heads of 64) with a full, a ragged, a 1-key
    and a 0-key row, K4-bf16's pass model lies within 1e-6 of max |O| of
    ``fused_qkv_attention_ref(..., "highest")`` on the upcast x, and no
    further from the JAX package's kernel at HIGHEST in interpret mode
    (``_fused_call``, head-major O) than the plain version is, plus 1e-6 of
    max |O|; the same for the sublayer, the model's O through the f32
    out-projection against ``fused_qkv_attention(mode="highest")`` and the
    port's plain sublayer. The JAX kernel gives the 0-key row the mean of
    every V row (its scores all -1e30): that row is held to the plain
    version alone, O = 0. The plain version on the bf16 x is the f32 one
    rounded once."""
    xb, wb, lengths = _fused_inputs(t, 700 + t)
    lens = torch.tensor(lengths, dtype=torch.int32)
    qkv = [torch.from_numpy(a) for w, bias in wb[:3] for a in (w, bias)]
    o = k4_pass_model(xb, qkv, lens)
    ref = fused_attention.fused_qkv_attention_ref(xb.float(), *qkv, lens, H, "highest")
    ref_b = fused_attention.fused_qkv_attention_ref(xb, *qkv, lens, H, "highest")
    assert ref_b.dtype == BF16 and torch.equal(ref_b, ref.to(BF16))
    tol = _tol(ref)
    assert (o - ref).abs().max().item() <= tol
    assert not o[3].any()
    # the kernel alone, as _fused_fwd_impl calls it
    x32 = np.asarray(xb.float().numpy())
    t_pad = jfa._round_up(t, 128)
    xp = jnp.pad(jnp.asarray(x32), ((0, 0), (0, t_pad - t), (0, 0)))
    hw = [jnp.asarray(w.T).reshape(DM, H, HD).transpose(1, 0, 2) for w, _ in wb[:3]]
    hb = [jnp.asarray(bias).reshape(H, 1, HD) for _, bias in wb[:3]]
    jx = torch.from_numpy(np.array(jfa._fused_call(
        xp, *hw, *hb, jnp.asarray(lengths, jnp.int32), H, jfa._block_q_for(t_pad), "highest",
        True)[:, :, :t]))
    rows = slice(0, 3)
    plain_gap = (ref[rows] - jx[rows]).abs().max().item()
    assert (o[rows] - jx[rows]).abs().max().item() <= plain_gap + tol
    # the sublayer
    wo, bo = (torch.from_numpy(a) for a in wb[3])
    key_mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    theirs = torch.from_numpy(np.array(jfa.fused_qkv_attention(
        x32, *(a for w, bias in wb for a in (w.T, bias)), key_mask=key_mask, heads=H,
        mode="highest", interpret=True)))
    plain = fused_attention.fused_qkv_attention(
        xb.float(), *qkv, wo, bo, key_mask=torch.from_numpy(key_mask), heads=H,
        precision="highest")
    ours = o.transpose(1, 2).reshape(len(lengths), t, DM) @ wo.T + bo
    tol = _tol(plain)
    assert (ours - plain).abs().max().item() <= tol
    plain_gap = (plain[rows] - theirs[rows]).abs().max().item()
    assert (ours[rows] - theirs[rows]).abs().max().item() <= plain_gap + tol


def test_k4_bf16_weight_planes_sum_to_the_weights():
    """``pack_weights_ref(..., planes=3)`` (K4-bf16's prologue): three bf16
    planes a weight, hi, mid and lo, each on bf16's grid, whose float64
    sum is the weight times SPLIT3_SCALE exactly, in the packed head-major
    layout of the one-plane packing; two planes are K4h's hi and lo."""
    rng = np.random.default_rng(8)
    ws = [torch.from_numpy((rng.standard_normal((DM, DM)) * np.exp2(
        rng.integers(-30, 30, (DM, DM)))).astype(np.float32)) for _ in range(3)]
    packed = fused_attention.pack_weights_ref(*ws, H, planes=3)
    rows = H * 3 * HD
    assert packed.dtype == BF16 and packed.shape == (3 * rows, DM)
    hi, mid, lo = packed.double().split(rows)
    one = fused_attention.pack_weights_ref(*(w.double().float() for w in ws), H)
    w64 = torch.stack([w.view(H, HD, DM) for w in ws], dim=1).reshape(rows, DM).double()
    assert torch.equal(hi + mid + lo, w64 * SCALE)
    assert torch.equal(hi.to(BF16), (one.double() * SCALE).to(BF16))
    two = fused_attention.pack_weights_ref(*ws, H, planes=2).float().split(rows)
    assert all(torch.equal(a, b) for a, b in zip(two, precision.split_bf16(w64.float())))


@pytest.mark.parametrize("b", [1, 32, 96])
def test_highest_bf16_fused_plan_fits_shared_memory(b):
    """``fused_launch_plan`` at "highest" on a bf16 x (K4-bf16): K4's
    cluster split with K4b's threads; its shared memory, the larger of a
    2-stage ring of x and three weight planes (2 x 80 KB) and phase 2's Q,
    K, V and three key tiles in three planes (216 KB), with the barriers
    and the alignment, stays within a block's 232,448 bytes and fits one
    block an SM; on an f32 x the plan stays K4's."""
    for t in (1, 50, 63, 64, 65, 127, 128, 129, 499, 511, 512, 1023, 1024):
        plan = fused_attention.fused_launch_plan(t, b, 12, "highest", bf16_x=True)
        f32 = fused_attention.fused_launch_plan(t, b, 12, "highest")
        assert f32.smem_bytes == fused_attention.FUSED_SMEM_BYTES
        assert (plan.cluster, plan.tensors_per_block, plan.grid) == (
            f32.cluster, f32.tensors_per_block, f32.grid)
        assert plan.threads == fused_attention.FUSED_BF16_THREADS == 160
        stage = 2 * 64 * (64 + 3 * 192)
        phase2 = 2 * 3 * (3 + 3 * 2) * 64 * 64
        assert plan.smem_bytes == max(2 * stage, phase2) + 2 * 2 * 8 + 1024 == 222_240
        assert plan.smem_bytes <= SMEM_LIMIT
        assert fused_attention.FUSED_HIGHEST_BF16_BLOCKS_PER_SM * (
            plan.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM
        assert 3 * stage > SMEM_LIMIT  # why the ring holds two stages


@pytest.mark.parametrize("b", [1, 32, 96])
def test_highest_bf16_flash_plan_is_k1b_blocks_at_three_planes(b):
    """At "highest" and "high" the forward plan is K1b's (64-row blocks of
    160 threads over the folded length, the same shared memory and 4-stage
    ring) with P . V at three passes, built for 2 blocks an SM: its shared
    memory fits the SM twice, and its 10 warps leave 3 on one of the SM's
    four 16,384-register partitions, so ptxas may give it 168 registers a
    thread (K1b at 3 blocks: 128)."""
    for t in (1, 50, 63, 64, 65, 127, 128, 129, 193, 257, 499, 511, 1024, 4095):
        plan = flash_attention.flash_bf16_launch_plan(t, b, 12, "highest")
        assert plan == flash_attention.flash_bf16_launch_plan(t, b, 12, "high")
        default = flash_attention.flash_bf16_launch_plan(t, b, 12)
        assert (plan["passes"], default["passes"]) == (3, 1)
        assert (plan["blocks_per_sm"], default["blocks_per_sm"]) == (2, 3)
        assert {f: v for f, v in plan.items() if f not in ("passes", "blocks_per_sm")} == {
            f: v for f, v in default.items() if f not in ("passes", "blocks_per_sm")}
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
        for p, want in ((plan, 168), (default, 128)):
            warps = -(-p["blocks_per_sm"] * p["threads"] // 32 // 4)  # on one partition
            assert min(255, 16384 // (32 * warps) // 8 * 8) == want


def test_highest_forward_routes():
    """CPU tensors take the plain version at every precision (bf16 in, bf16
    out, the f32 flavour rounded once); the wrappers refuse, before they
    touch the card, f32 tensors at "highest" for K1-bf16 (they run K1) and
    bf16 ones for K1 (they run K1-bf16), and a bf16 x at "highest" takes
    K4-bf16's entry with three weight planes, an f32 x K4's."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 20, H, HD, generator=g).to(BF16) for _ in range(3))
    lens = torch.tensor([20, 7], dtype=torch.int32)
    before = (flash_attention.launches_f32_bf16_io, flash_attention.launches)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    o32, lse32 = flash_attention.mha_flash(q.float(), k.float(), v.float(), lens, "highest")
    assert (flash_attention.launches_f32_bf16_io, flash_attention.launches) == before
    assert o.dtype == BF16 and torch.equal(o, o32.to(BF16)) and torch.equal(lse, lse32)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention._flash_bf16_kernel(q.float(), k.float(), v.float(), lens, "highest")
    with pytest.raises(TypeError, match="float32"):
        flash_attention._flash_kernel(q, k, v, lens)
    assert flash_attention._fwd_bf16_passes(q, "high") == 3
    assert flash_attention._fwd_bf16_passes(q, "default") == 1
    assert flash_attention._fwd_bf16_passes(q.float(), "default") == 1
    assert fused_attention._KERNELS["highest", True] == (
        "fused_attention_bf16", "nomad_fused_qkv_attention_highest_fwd")
    assert fused_attention._KERNELS["highest", False][0] == "fused_attention"
    assert [fused_attention._planes(p, bf) for p in ("highest", "high", "default")
            for bf in (False, True)] == [0, 3, 2, 2, 1, 1]
    x = torch.randn(2, 20, DM, generator=g).to(BF16)
    params = [a for _ in range(3) for a in (torch.randn(DM, DM, generator=g) / DM**0.5,
                                            0.1 * torch.randn(DM, generator=g))]
    before = fused_attention.launches_f32_bf16_io
    ob = fused_attention.fused_qkv_mha(x, *params, lens, H, "highest")
    assert fused_attention.launches_f32_bf16_io == before
    assert ob.dtype == BF16 and torch.equal(
        ob, fused_attention.fused_qkv_mha(x.float(), *params, lens, H, "highest").to(BF16))
