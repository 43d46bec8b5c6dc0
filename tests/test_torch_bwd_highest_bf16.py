"""The "highest" attention backward on bf16 tensors (K2-bf16 and K3-bf16,
``csrc/flash_attention_bwd_bf16.cu`` at three passes) on the CPU.

(1) ``precision.split3_bf16``, the plain version of the kernels' register
split of dS and P into three bf16 planes: hi + mid + lo == x exactly,
checked in float64, on x scaled by ``SPLIT3_SCALE`` as the kernels scale
it (and unscaled wherever x's last bit lies on bf16's grid). (2) A pass
model of the two kernels written here (S and dP from the bf16 operands in
f32; dS and P scaled and split into planes; each 64-key or 64-query tile's
three plane products summed apart in f32, then added across tiles) against
``flash_attention_bwd_ref(..., "highest")`` and the JAX package's
``mha_pallas`` backward at HIGHEST in interpret mode, on the same seeded
bf16 inputs: within 1e-6 of max |g| of the plain version, and no further
from the JAX kernel than the plain version is, plus 1e-6. The planes lose
nothing, so what is left is f32 summation order. (3) The launch plan at "highest" and the
wrapper's routing rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import flash_attention as jfl
from nomad_tpu.ops.flash_attention import mha_pallas
from nomad_tpu_torch.ops import flash_attention, precision

torch.set_num_threads(2)
H, HD = 2, 64
TILE = 64  # rows of the kernels' tiles and blocks
BF16 = torch.bfloat16
HIGHEST = jax.lax.Precision.HIGHEST
PASS_MODEL_REL = 1e-6  # f32 sums in other orders, relative to max |g|
NOISE = 1e-4  # max |g| of an output that is rounding noise (analytically 0)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SMEM_PER_SM, SMEM_RESERVED = 228 * 1024, 1024
BATCHES = (1, 16, 24, 32, 96)


def _f32_bits(bits):
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.float32).copy())


def _split_values():
    """{case: f32 tensor} of the values the split must take exactly."""
    rng = np.random.default_rng(5)
    normals = rng.standard_normal(20_000) * np.exp2(rng.integers(-100, 100, 20_000))
    # bf16 rounding ties: a bf16 value plus half its step, both signs
    base = torch.from_numpy(rng.standard_normal(4_000).astype(np.float32)).to(BF16).float()
    ties = base + torch.sign(base) * precision.round_bf16(base).abs() * 2.0**-8
    return {
        "normals": torch.from_numpy(normals.astype(np.float32)),
        "probabilities": torch.from_numpy(rng.random(20_000).astype(np.float32)),
        "ties": torch.cat([ties, -ties]),
        "1e-30": torch.tensor([1e-30, -1e-30, 3e-30, 7.5e-31]),
        "subnormals": torch.cat([_f32_bits(rng.integers(1, 2**23, 4_000)),
                                 -_f32_bits([1, 2, 3, 2**22, 2**23 - 1])]),
        "zeros": torch.tensor([0.0, -0.0]),
    }


@pytest.mark.parametrize("case", ["normals", "probabilities", "ties", "1e-30", "subnormals",
                                  "zeros"])
def test_split3_bf16_is_exact(case):
    """hi + mid + lo == x in float64, every plane a bf16 value, for x times
    SPLIT3_SCALE (what the kernels split: exact for any f32 x below 2^112
    in magnitude, subnormals included) and, but for subnormals and normals
    below 2^-110 (their last bit below bf16's grid), for x itself."""
    x = _split_values()[case]
    for scale in (precision.SPLIT3_SCALE, 1.0):
        xs = x * scale
        assert torch.equal(xs / scale, x)  # the scale is exact
        planes = precision.split3_bf16(xs)
        assert all(torch.equal(p, p.to(BF16).float()) for p in planes)
        total = sum(p.double() for p in planes)
        exact = total == xs.double()
        if scale == 1.0:
            on_grid = (xs.abs() >= 2.0**-110) | (xs == 0)
            assert exact[on_grid].all(), case
        else:
            assert exact.all(), case
    hi, mid, lo = precision.split3_bf16(x * precision.SPLIT3_SCALE)
    # hi is the nearest bf16 and each plane at most half a step of the one before
    assert torch.equal(hi, precision.round_bf16(x * precision.SPLIT3_SCALE))
    assert (mid.abs() <= hi.abs() * 2.0**-8).all() and (lo.abs() <= mid.abs() * 2.0**-8).all()


def test_split3_bf16_is_what_the_kernels_split():
    """The plain split names the three planes hi = bf16(x), mid = bf16(x -
    hi), lo = bf16(x - hi - mid); the unscaled split of a subnormal loses
    its bits below 2^-133, which is why the kernels scale first."""
    x = torch.tensor([1.0 + 2.0**-9 + 2.0**-18, 2.0**-140, 3.0 * 2.0**-149])
    hi, mid, lo = precision.split3_bf16(x)
    assert hi[0] == 1.0 and mid[0] == 2.0**-9 and lo[0] == 2.0**-18
    assert hi[1] + mid[1] + lo[1] != x[1] and hi[2] + mid[2] + lo[2] != x[2]
    scaled = precision.split3_bf16(x * precision.SPLIT3_SCALE)
    assert torch.equal(sum(p.double() for p in scaled), (x * precision.SPLIT3_SCALE).double())


# ---------------- (2) the pass model against the plain version and Pallas ----------------


def _planes_product(x, y, eq):
    """einsum(eq, x, y) of f32 x, one f32 product a plane of x scaled by
    SPLIT3_SCALE (lo, mid, then hi: the kernels' order) summed in f32,
    unscaled: the kernels' three passes of one tile."""
    planes = precision.split3_bf16(x * precision.SPLIT3_SCALE)
    part = None
    for plane in reversed(planes):
        term = torch.einsum(eq, plane, y)
        part = term if part is None else part + term
    return part / precision.SPLIT3_SCALE


def pass_model(q, k, v, o, lse, do, lengths):
    """K2-bf16's and K3-bf16's arithmetic in f32 on the CPU, for bf16 q, k,
    v, dO [B, T, H, 64], O [B, T, H, 64] (Di = rowsum(dO o O) in f32) and
    LSE [B, H, T]: S = q.k and dP = dO.v^T of the bf16 operands in f32 (the
    products are exact), P = exp(S / 8 - LSE) over the valid keys, dS = P
    (dP - Di); dQ sums each 64-key tile's three plane products of dS with
    K apart and adds the tiles in order, dK and dV each 64-query tile's of
    dS^T with Q and of P^T with dO; dK = dV = 0 past each bound. Returns
    f32 (dQ, dK, dV)."""
    b, t, h, d = q.shape
    scale = 1.0 / d**0.5
    lens = lengths.long().clamp(0, t)
    valid = torch.arange(t)[None, :] < lens[:, None]  # [B, T]
    vk = valid[:, :, None, None]
    qf, dof = q.float(), do.float()
    kf, vf = (torch.where(vk, x.float(), 0.0) for x in (k, v))
    di = (dof * o.float()).sum(dim=-1).transpose(1, 2)  # [B, H, T]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.where(valid[:, None, None, :], torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None])
    dq = torch.zeros(b, t, h, d)
    dk = torch.zeros(b, t, h, d)
    dv = torch.zeros(b, t, h, d)
    for t0 in range(0, t, TILE):
        keys, rows = slice(t0, t0 + TILE), slice(t0, t0 + TILE)
        dq += _planes_product(ds[..., keys], kf[:, keys], "bhqk,bkhd->bqhd")
        dk[:, :] += _planes_product(ds[:, :, rows], qf[:, rows], "bhqk,bqhd->bkhd")
        dv[:, :] += _planes_product(p[:, :, rows], dof[:, rows], "bhqk,bqhd->bkhd")
    return dq * scale, torch.where(vk, dk * scale, 0.0), torch.where(vk, dv, 0.0)


def _edge_lengths(t):
    """A full, a ragged, a 1-key and a 0-key row."""
    return [t, max(t // 2, 1), 1, 0]


def jax_forward_and_grads(q, k, v, do, lengths):
    """The JAX package's ``mha_pallas`` at HIGHEST in interpret mode on f32
    [B, T, H, 64] tensors: its O and saved LSE ([B, H, T]) and ``jax.vjp``'s
    (dQ, dK, dV) for dO, as torch tensors."""
    b, t, h, _ = q.shape
    mask = jnp.asarray(np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    qj, kj, vj, doj = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    # mha_pallas's blocks, for its forward's residuals
    bk = min(2048, 1 << max(7, (jfl._round_up(t, 128) - 1).bit_length()))
    _, res = jfl._mha_pallas_fwd(qj, kj, vj, mask, min(512, bk), bk, True, HIGHEST)
    lse = torch.from_numpy(np.array(res[5])[:, 0, :t].reshape(b, h, t).copy())
    o, vjp = jax.vjp(lambda a, c, e: mha_pallas(a, c, e, mask, interpret=True,
                                                precision=HIGHEST), qj, kj, vj)
    return (torch.from_numpy(np.array(o)), lse,
            tuple(torch.from_numpy(np.array(g)) for g in vjp(doj)))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 129])
def test_pass_model_matches_the_plain_version_and_mha_pallas(t):
    """On seeded bf16 q, k, v, dO and the JAX kernel's O and LSE (so that
    all three take the same Di and P), the pass model lies within 1e-6 of
    max |g| of ``flash_attention_bwd_ref(..., "highest")`` on the same
    values in f32 (the contract: f32 products, one f32 sum each), and no
    further from the JAX package's ``mha_pallas`` backward at HIGHEST in
    interpret mode than that plain version is, plus 1e-6 of max |g| (the
    JAX kernel's own f32 order puts the plain version up to ~2e-6 of max
    |dK| from it: dS = P (dP - Di) cancels). An output that is rounding
    noise (max |g| <= 1e-4: dQ and dK with one key, analytically 0) is held
    to 1e-6 absolute. The 0-key row's gradients are 0 in the model and the
    plain version (the JAX kernel leaves that row undefined). The plain
    version on the bf16 tensors is the f32 one rounded once, as the
    kernels' outputs are."""
    rng = np.random.default_rng(400 + t)
    lengths = _edge_lengths(t)
    b = len(lengths)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, H, HD)).astype(np.float32))
                   .to(BF16) for _ in range(4))
    up = [x.float() for x in (q, k, v, do)]
    lens = torch.tensor(lengths, dtype=torch.int32)
    o, lse, grads_j = jax_forward_and_grads(*up, lengths)
    model = pass_model(q, k, v, o, lse, do, lens)
    plain = flash_attention.flash_attention_bwd_ref(*up[:3], o, lse, up[3], lens, "highest")
    plain_bf16 = flash_attention.flash_attention_bwd_ref(q, k, v, o.to(BF16), lse, do, lens,
                                                         "highest")
    o_rounded = flash_attention.flash_attention_bwd_ref(*up[:3], o.to(BF16).float(), lse,
                                                        up[3], lens, "highest")
    assert all(torch.equal(x, y.to(BF16)) for x, y in zip(plain_bf16, o_rounded))
    rows = slice(0, 3)  # the JAX kernel's 0-key row is not defined
    for name, ours, ref, jx in zip(("dq", "dk", "dv"), model, plain, grads_j):
        gmax = ref.abs().max().item()
        tol = PASS_MODEL_REL * gmax if gmax > NOISE else PASS_MODEL_REL
        assert (ours - ref).abs().max().item() <= tol, name
        plain_gap = (ref[rows] - jx[rows]).abs().max().item()
        assert (ours[rows] - jx[rows]).abs().max().item() <= plain_gap + tol, name
        assert not ours[3].any() and not ref[3].any(), name


# ---------------- (3) the launch plan and the routes ----------------


@pytest.mark.parametrize("b", BATCHES)
def test_highest_bf16_plan_is_k2b_k3b_blocks_at_three_passes(b):
    """At "highest" and "high" the plan is K2b/K3b's (64-row blocks of 160
    threads over the folded length, one per row of every head and batch
    row, none wholly in the padding; the same dynamic shared memory, 3
    stages) at three passes, built for 2 blocks an SM (K2-bf16) and 1
    (K3-bf16): their shared memory fits the SM that many times, and
    their registers (ptxas: at most 65,536 / (blocks x 160) a thread, the
    kernels' __launch_bounds__) leave K2-bf16 200 a thread and K3-bf16
    255."""
    tile = 64 * 64 * 2
    for t in (1, 31, 50, 63, 64, 65, 127, 128, 129, 191, 193, 257, 499, 511, 1024, 1433, 4095):
        plans = flash_attention.flash_bwd_bf16_launch_plan(t, b, 12, "highest")
        assert plans == flash_attention.flash_bwd_bf16_launch_plan(t, b, 12, "high")
        default = flash_attention.flash_bwd_bf16_launch_plan(t, b, 12)
        assert {k: p["blocks_per_sm"] for k, p in plans.items()} == {"dq": 2, "dkv": 1}
        for kernel, plan in plans.items():
            assert plan["passes"] == 3 and default[kernel]["passes"] == 1
            assert {f: v for f, v in plan.items() if f not in ("passes", "blocks_per_sm")} == {
                f: v for f, v in default[kernel].items() if f not in ("passes", "blocks_per_sm")}
            tiles, h, bb = plan["grid"]
            assert (h, bb, plan["threads"], plan["rows_per_block"]) == (12, b, 160, 64)
            assert plan["t_pad"] == tiles * 64 and (tiles - 1) * 64 < t <= tiles * 64
            assert plan["smem_bytes"] == 2 * tile + 3 * 2 * tile + 3 * 2 * 64 * 4 + 7 * 8 + 1024
            assert plan["smem_bytes"] <= SMEM_LIMIT
            assert plan["blocks_per_sm"] * (plan["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
            regs = 65536 // (plan["blocks_per_sm"] * plan["threads"]) // 8 * 8
            assert min(regs, 255) == {"dq": 200, "dkv": 255}[kernel]


def test_highest_backward_routes():
    """CPU tensors take the plain version at every precision (bf16 in,
    bf16 out, the f32 flavour rounded once); the kernels' wrapper refuses
    f32 tensors at "highest" (they run K2 and K3) before it touches the
    card, and K2 and K3 refuse bf16 ones."""
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(2, 20, H, HD, generator=g).to(BF16) for _ in range(4))
    lens = torch.tensor([20, 7], dtype=torch.int32)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    grads = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "highest")
    grads32 = flash_attention.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(),
                                                  lse, do.float(), lens, "highest")
    assert all(x.dtype == BF16 and torch.equal(x, y.to(BF16)) for x, y in zip(grads, grads32))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention._bwd_bf16(q.float(), k.float(), v.float(), do.float(), lse, lse,
                                  lens, "highest")
    with pytest.raises(TypeError, match="float32"):
        flash_attention._bwd_dkv_kernel(q, k, v, do, lse, lse, lens)
    assert flash_attention._bwd_bf16_passes(q, "high") == 3
    assert flash_attention._bwd_bf16_passes(q, "default") == 1
    assert flash_attention._bwd_bf16_passes(q.float(), "default") == 1
