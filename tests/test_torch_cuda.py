"""The port's hand-written kernels on the card, against their plain
versions. Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.models.wav2vec2 import PRECISION_ISLANDS
from nomad_tpu_torch.ops import flash_attention, fused_attention, layernorm
from nomad_tpu_torch.ops import precision as prec_ops

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("width", [512, 768, 64])
def test_layer_norm_kernel_matches_ref(cuda, width):
    g = torch.Generator().manual_seed(width)
    x = (3 * torch.randn(1001, width, generator=g) + 1).to(cuda)
    w = torch.randn(width, generator=g).to(cuda)
    b = torch.randn(width, generator=g).to(cuda)
    before = layernorm.launches
    out = layernorm.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert layernorm.launches == before + 1
    torch.testing.assert_close(out, layernorm.layer_norm_ref(x, w, b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,lengths", [(300, [300, 129, 1]), (77, [77, 64, 13])])
def test_flash_kernel_matches_ref(cuda, t, lengths):
    g = torch.Generator().manual_seed(t)
    b, h, d = len(lengths), 4, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(cuda)
    q, k, v = qkv.unbind(2)  # strided views, as the model hands them over
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rlse = flash_attention.flash_attention_ref(q, k, v, lens)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o, ro, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=0)


def test_flash_kernel_ignores_nan_past_the_bound(cuda):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 130, 2, 64, generator=g).to(cuda) for _ in range(3))
    k[:, 100:] = float("nan")
    v[:, 100:] = float("nan")
    lens = torch.tensor([100, 0], dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    assert torch.isfinite(o).all() and torch.isfinite(lse[0]).all()
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.all(lse[1] == flash_attention.NEG_INF)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 64, device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm.layer_norm(x.t().contiguous().t(), w, b)
    with pytest.raises(TypeError, match="float32"):
        layernorm.layer_norm(x.double(), w, b)
    # gradients pass: K5 forward, the plain backward
    xg = x.clone().requires_grad_()
    g = torch.randn_like(x)
    layernorm.layer_norm(xg, w, b).backward(g)
    torch.testing.assert_close(xg.grad, layernorm.layer_norm_bwd_ref(x, w, g)[0],
                               atol=1e-5, rtol=0)
    q = torch.randn(1, 10, 2, 32, device=cuda)
    lens = torch.tensor([10], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        flash_attention.mha_flash(q, q, q, lens)
    q = torch.randn(1, 10, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="lengths"):
        flash_attention.mha_flash(q, q, q, lens.long())
    # gradients pass: K1 forward, K2 + K3 backward
    qg = q.clone().requires_grad_()
    before = (flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv)
    flash_attention.FlashAttention.apply(qg, q, q, lens).sum().backward()
    assert (flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(qg.grad).all()


@pytest.mark.parametrize("t", [1, 31, 32, 33, 63, 64, 65, 499, 4095])
def test_flash_backward_kernels_match_ref(cuda, t):
    """K2 and K3 against the plain version at every edge of their tiles
    (32-row streamed tiles; 32-row blocks up to T = 64, 64-row blocks
    beyond), each batch with a full row, a ragged one, a 1-key row and a
    0-key row: NaN in k and v past the bound reaches nothing, dK = dV = 0
    there, a length-0 row gets zero gradients, dO read through non-unit
    strides gives the same result, and a second call the same bits."""
    lengths = [t, max(t // 2, 1), 1, 0]
    g = torch.Generator().manual_seed(t + 1)
    b, h, d = len(lengths), 4, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(cuda)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    do = torch.randn(b, t, 2, h, d, generator=g).to(cuda)[:, :, 0]  # strided dO
    before = (flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv)
    dq, dk, dv = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens)
    torch.cuda.synchronize()
    assert (flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv) == (
        before[0] + 1, before[1] + 1)
    # f32 sums of up to T terms: 2e-5 up to 512, growing as sqrt(T) beyond,
    # and 1e-5 relative there (the 1-key row's dV sums every query's dO)
    atol, rtol = 2e-5 * max(1.0, (t / 512) ** 0.5), (2e-6 if t <= 512 else 1e-5)
    for i in range(b):  # the plain version one batch row at a time
        sl = slice(i, i + 1)
        ref = flash_attention.flash_attention_bwd_ref(
            q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], lens[sl])
        for ours, theirs in zip((dq, dk, dv), ref):
            assert torch.isfinite(ours[sl]).all()
            torch.testing.assert_close(ours[sl], theirs, atol=atol, rtol=rtol)
    for i, n in enumerate(lengths):
        assert torch.all(dk[i, n:] == 0) and torch.all(dv[i, n:] == 0)
        if n == 0:
            assert torch.all(dq[i] == 0)
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), lens)
    for a, c in zip((dq, dk, dv), again):
        assert torch.equal(a, c)


def test_model_kernel_path_matches_plain_path(cuda):
    """A narrow model with 64-wide heads: kernel path vs plain path on the
    card, padded batch vs batch-1, and 2 + 4 launches per block."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(**kw), emb_dim=16), seed=0)
    ref = NomadModel(Wav2Vec2Config.tiny(attention_impl="ref", layernorm_impl="ref", **kw),
                     emb_dim=16)
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(cuda).eval(), ref.to(cuda).eval()
    g = torch.Generator().manual_seed(2)
    lengths = torch.tensor([4000, 2500, 900])
    wav = torch.zeros(3, 4000)
    for i, n in enumerate(lengths):
        wav[i, :n] = 0.3 * torch.randn(int(n), generator=g)
    wav, lengths = wav.to(cuda), lengths.to(cuda)
    flash_attention.launches = layernorm.launches = 0
    with torch.inference_mode():
        emb = model(wav, lengths)
        assert flash_attention.launches == 2 and layernorm.launches == 2 * 2 + 2
        torch.testing.assert_close(emb, ref(wav, lengths), atol=1e-5, rtol=0)
        for i, n in enumerate(lengths.tolist()):
            torch.testing.assert_close(emb[i:i + 1], model(wav[i:i + 1, :n]), atol=1e-5, rtol=0)


def test_loss_kernel_path_matches_plain_path(cuda):
    """The NOMAD loss on a narrow model with 64-wide heads: value and
    d loss / d estimate on the kernel path against the plain path, and
    K1/K5 twice per forward pair, K2/K3 once per block in the backward."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    cfg = Wav2Vec2Config.tiny(**kw)
    sd = init_weights(NomadModel(cfg, emb_dim=16), seed=0).state_dict()
    nomad = Nomad(device="cuda", config=cfg, emb_dim=16, params=sd)
    plain = Nomad(device="cuda", config=Wav2Vec2Config.tiny(
        attention_impl="ref", layernorm_impl="ref", **kw), emb_dim=16, params=sd)
    g = torch.Generator().manual_seed(3)
    clean = 0.3 * torch.randn(4, 1, 4000, generator=g)
    est = (clean + 0.05 * torch.randn(4, 1, 4000, generator=g)).requires_grad_()
    flash_attention.launches = layernorm.launches = 0
    flash_attention.launches_bwd_dq = flash_attention.launches_bwd_dkv = 0
    loss = nomad.forward(est, clean)
    loss.backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, layernorm.launches) == (2 * 2, 2 * (2 * 2 + 2))
    assert (flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv) == (2, 2)
    assert est.grad.device.type == "cpu" and torch.isfinite(est.grad).all()
    torch.testing.assert_close(loss, plain.forward(est, clean), rtol=1e-5, atol=0)
    # the plain path's gradient under the kernel path's subgradient of |.|:
    # an element of a layer difference within rounding of 0 may take the
    # other sign on the other path, which alone moves the gradient by
    # 2/numel of that element's Jacobian row
    with torch.no_grad():
        signs = [torch.sign(a - c) for a, c in zip(
            nomad.model.forward_layers(nomad._waves(est)),
            nomad.model.forward_layers(nomad._waves(clean)))]
    est_ref = est.detach().clone().requires_grad_()
    with torch.no_grad():
        ref_clean = plain.model.forward_layers(plain._waves(clean))
    sum((s_ * (a - c)).mean() for s_, a, c in zip(
        signs, plain.model.forward_layers(plain._waves(est_ref)), ref_clean)).backward()
    assert (est.grad - est_ref.grad).abs().max() <= 1e-4 * est_ref.grad.abs().max()
    assert nomad.forward(clean, clean).item() == 0.0


def _fused_inputs(cuda, b, t, heads, seed):
    """x and the q/k/v projections ([out, in]) at the model's scales."""
    g = torch.Generator().manual_seed(seed)
    dm = 64 * heads
    x = torch.randn(b, t, dm, generator=g)
    ws = [torch.randn(dm, dm, generator=g) / dm**0.5 for _ in range(3)]
    bs = [0.1 * torch.randn(dm, generator=g) for _ in range(3)]
    params = [a.to(cuda) for pair in zip(ws, bs) for a in pair]  # wq, bq, wk, bk, wv, bv
    return x.to(cuda), params


@pytest.mark.parametrize("t", [1, 50, 511, 1024])
def test_fused_kernel_matches_ref(cuda, t):
    """K4 against its plain version, every query row written, a length-0
    row finite and 0, and one launch per call."""
    lengths = [t, max(t // 2, 1), 0]
    x, params = _fused_inputs(cuda, len(lengths), t, 2, t)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = fused_attention.launches
    o = fused_attention.fused_qkv_mha(x, *params, lens, 2)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert o.shape == (3, 2, t, 64) and torch.isfinite(o).all()
    assert torch.equal(o[2], torch.zeros_like(o[2]))
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, 2)
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=1e-5)


def test_fused_kernel_ignores_garbage_past_the_bound(cuda):
    lengths = [700, 64, 1]
    x, params = _fused_inputs(cuda, 3, 770, 2, 5)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    clean = fused_attention.fused_qkv_mha(x, *params, lens, 2)
    for i, n in enumerate(lengths):
        x[i, n:] = 123.0
    dirty = fused_attention.fused_qkv_mha(x, *params, lens, 2)
    assert torch.isfinite(dirty).all()
    for i, n in enumerate(lengths):
        assert torch.equal(dirty[i, :, :n], clean[i, :, :n])


def test_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, params = _fused_inputs(cuda, 2, 40, 2, 7)
    lens = torch.tensor([40, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        fused_attention.fused_qkv_mha(x, *params, lens, 4)
    xl, pl = _fused_inputs(cuda, 1, 1025, 2, 8)
    with pytest.raises(ValueError, match="1024"):
        fused_attention.fused_qkv_mha(xl, *pl, lens[:1], 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention.fused_qkv_mha(x.transpose(0, 1).contiguous().transpose(0, 1),
                                      *params, lens, 2)
    with pytest.raises(TypeError, match="float32"):
        fused_attention.fused_qkv_mha(x.double(), *params, lens, 2)
    with pytest.raises(ValueError, match="lengths"):
        fused_attention.fused_qkv_mha(x, *params, lens.long(), 2)
    with pytest.raises(ValueError, match="is on"):
        fused_attention.fused_qkv_mha(x, params[0].cpu(), *params[1:], lens, 2)


def test_fused_gradient_matches_plain_autograd(cuda):
    """FusedQKVAttention's backward (K1 + K2 + K3 on the recomputed
    projections) against autograd through the plain version, for x and
    every projection tensor."""
    x, params = _fused_inputs(cuda, 3, 130, 2, 9)
    lens = torch.tensor([130, 77, 1], dtype=torch.int32, device=cuda)
    do = torch.randn(3, 2, 130, 64, generator=torch.Generator().manual_seed(10)).to(cuda)
    ours = [a.clone().requires_grad_() for a in (x, *params)]
    theirs = [a.clone().requires_grad_() for a in (x, *params)]
    counts = lambda: (fused_attention.launches, flash_attention.launches,  # noqa: E731
                      flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv)
    before = counts()
    o = fused_attention.FusedQKVAttention.apply(*ours, lens, 2)
    o.backward(do)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    fused_attention.fused_qkv_attention_ref(*theirs, lens, 2).backward(do)
    for a, r in zip(ours, theirs):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=1e-4)


def test_model_fused_path_matches_plain_path(cuda):
    """The narrow model on the fused path at "highest": K4 once per block
    and no K1, embeddings against the plain path and batch-1 against the
    padded batch."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv",
                                                        encoder_precision="highest", **kw),
                                    emb_dim=16), seed=0)
    ref = NomadModel(Wav2Vec2Config.tiny(attention_impl="ref", layernorm_impl="ref", **kw),
                     emb_dim=16)
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(cuda).eval(), ref.to(cuda).eval()
    g = torch.Generator().manual_seed(4)
    lengths = torch.tensor([4000, 2500, 900])
    wav = torch.zeros(3, 4000)
    for i, n in enumerate(lengths):
        wav[i, :n] = 0.3 * torch.randn(int(n), generator=g)
    wav, lengths = wav.to(cuda), lengths.to(cuda)
    fused_attention.launches = flash_attention.launches = 0
    with torch.inference_mode():
        emb = model(wav, lengths)
        assert (fused_attention.launches, flash_attention.launches) == (2, 0)
        torch.testing.assert_close(emb, ref(wav, lengths), atol=1e-5, rtol=0)
        for i, n in enumerate(lengths.tolist()):
            torch.testing.assert_close(emb[i:i + 1], model(wav[i:i + 1, :n]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", [50, 511, 4095])
def test_flash_kernel_tile_edges_with_nan_past_the_bound(cuda, t):
    """K1's 64-query, 32-key tiles at the paths' lengths: ragged down to
    one key and to none, NaN in k and v past each bound."""
    lengths = [t, t // 2 + 1, 33, 32, 31, 1, 0]
    g = torch.Generator().manual_seed(t + 7)
    b, h, d = len(lengths), 2, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(cuda)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    for i in range(b):  # the plain version one batch row at a time
        ro, rlse = flash_attention.flash_attention_ref(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], lens[i:i + 1])
        torch.testing.assert_close(o[i:i + 1], ro, atol=2e-5, rtol=0)
        torch.testing.assert_close(lse[i:i + 1], rlse, atol=2e-5, rtol=0)
    assert torch.equal(o[-1], torch.zeros_like(o[-1]))
    assert torch.all(lse[-1] == flash_attention.NEG_INF)


@pytest.mark.parametrize("t", [1, 50, 63, 64, 65, 127, 128, 129, 511, 512, 1023, 1024])
def test_fused_kernel_cluster_edges(cuda, t):
    """K4 where its launch plan changes: one tensor per block up to 64
    frames, a cluster of ceil(T / 64) chunks beyond (2 .. 16 blocks). Rows
    ragged down to one key and to none; the valid rows of a call with
    123.0 past each bound are the same bits as with zeros there."""
    lengths = sorted({t, max(t // 2, 1), min(t, 65), min(t, 64), 1}, reverse=True) + [0]
    x, params = _fused_inputs(cuda, len(lengths), t, 2, 100 + t)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    o = fused_attention.fused_qkv_mha(x, *params, lens, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.equal(o[-1], torch.zeros_like(o[-1]))
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, 2)
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=1e-5)
    for i, n in enumerate(lengths):
        x[i, n:] = 123.0
    dirty = fused_attention.fused_qkv_mha(x, *params, lens, 2)
    assert torch.isfinite(dirty).all()
    for i, n in enumerate(lengths):
        assert torch.equal(dirty[i, :, :n], o[i, :, :n])


def test_kernel_occupancy(cuda):
    """K1 keeps 3 blocks on an SM, K4 2, K2 and K3 what their launch plan
    claims (2 blocks of 64 rows, 4 of 16), and every cluster size K4 uses
    fits on the card."""
    assert flash_attention.flash_occupancy() >= 3
    for t in (50, 499):
        for kernel, plan in flash_attention.flash_bwd_launch_plan(t, 1, 12).items():
            assert flash_attention.flash_bwd_occupancy(kernel, plan["rows_per_block"]) >= (
                plan["blocks_per_sm"]), (kernel, t)
    for t in (50, 65, 511, 1024):
        blocks, clusters = fused_attention.fused_occupancy(t)
        assert blocks >= 2 and clusters >= 1


def attention_f64(q, k, v, lengths):
    """Exact masked attention in float64 (the oracle of K1b and of its plain
    version): keys past each bound ignored, a row with no key 0."""
    b, t, h, d = q.shape
    valid = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    kd = torch.where(valid[:, :, None, None], k, 0.0).double()
    vd = torch.where(valid[:, :, None, None], v, 0.0).double()
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / d**0.5, kd)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd)


def check_bf16_flash(cuda, lengths, t, h, seed):
    """K1b against its plain version ("default"): every row finite, LSE
    within K1's 2e-5 of the plain one, O no further from exact f64
    attention than 1.5 x the plain version's distance + 1e-6 and no nearer
    than half of it (it does round), NaN past
    each bound reaching nothing, a 0-key row O = 0 and LSE = -1e30, and a
    rerun the same bits."""
    g = torch.Generator().manual_seed(seed)
    b, d = len(lengths), 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(cuda)
    q, k, v = qkv.unbind(2)  # strided views, as the model hands them over
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = (flash_attention.launches, flash_attention.launches_bf16)
    o, lse = flash_attention.mha_flash(q, k, v, lens, precision="default")
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_bf16) == (before[0], before[1] + 1)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    worst = worst_plain = 0.0
    for i in range(b):  # one batch row at a time: [1, H, T, T] in f64
        sl = slice(i, i + 1)
        ro, rlse = flash_attention.flash_attention_ref(q[sl], k[sl], v[sl], lens[sl], "default")
        exact = attention_f64(q[sl], k[sl], v[sl], lens[sl])
        err = (o[sl].double() - exact).abs().max().item()
        err_plain = (ro.double() - exact).abs().max().item()
        assert err <= 1.5 * err_plain + 1e-6, (i, err, err_plain)
        worst, worst_plain = max(worst, err), max(worst_plain, err_plain)
        torch.testing.assert_close(lse[sl], rlse, atol=2e-5, rtol=0)
    assert worst >= 0.5 * worst_plain, (worst, worst_plain)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(o[i], torch.zeros_like(o[i]))
            assert torch.all(lse[i] == flash_attention.NEG_INF)
    again = flash_attention.mha_flash(q, k, v, lens, precision="default")
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 511])
def test_bf16_flash_kernel_tile_edges(cuda, t):
    """K1b at every edge of its 16-row warp tiles, 64-row blocks and 64-key
    tiles: a full row, a ragged one, 1 key and none."""
    check_bf16_flash(cuda, [t, max(t // 2, 1), 1, 0], t, 4, 300 + t)


@pytest.mark.parametrize("b,t,lengths", [(32, 50, [50] * 32),
                                          (8, 4095, [4095, 4000, 3001, 2048, 1025, 513, 64, 1])])
def test_bf16_flash_kernel_at_path_shapes(cuda, b, t, lengths):
    check_bf16_flash(cuda, lengths, t, 12 if t < 1000 else 2, b + t)


# the edges of K1b's ring of 4 (K, V) stages: 2, 3, 4 and 5 key tiles
K1B_RING_EDGES = [127, 128, 129, 191, 192, 193, 257]


@pytest.mark.parametrize("t", K1B_RING_EDGES)
def test_bf16_flash_kernel_ring_edges(cuda, t):
    """K1b at every edge of its ring of (K, V) stages, NaN past each bound:
    a full row, a ragged one, 1 key and none."""
    check_bf16_flash(cuda, [t, max(t // 2, 1), 1, 0], t, 4, 400 + t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_flash_one_call_is_the_prologue_and_kernel_alone(cuda, dtype):
    """``mha_flash``'s one C call (prologue, K1b) gives the bits of the two
    launched one at a time and counts one launch of each; the prologue's
    fold is ``fold_bf16_ref`` of k and v bit for bit (0 past each bound,
    NaN there included); a workspace made for another shape is refused."""
    g = torch.Generator().manual_seed(6)
    b, t, h, lengths = 4, 257, 3, [257, 130, 1, 0]
    q, k, v = (torch.randn(b, t, h, 64, generator=g).to(cuda).to(dtype) for _ in range(3))
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    io = "_io" if dtype == torch.bfloat16 else ""
    names = [f"launches_fwd_fold_bf16{io}", f"launches_bf16{io}"]
    before = [getattr(flash_attention, n) for n in names]
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    assert [getattr(flash_attention, n) for n in names] == [c + 1 for c in before]
    ws = flash_attention._flash_bf16_fold(q, k, v, lens)
    alone = flash_attention._flash_bf16_body(q, ws, lens)
    torch.cuda.synchronize()
    assert ws.shape == (2, b * h, 320, 64)
    for n, x in enumerate((k, v)):
        assert torch.equal(ws[n], flash_attention.fold_bf16_ref(x, lens, True)), n
    assert torch.equal(alone[0], o) and torch.equal(alone[1], lse)
    with pytest.raises(ValueError, match="workspace"):
        flash_attention._flash_bf16_body(q[:, :64], ws, lens)


def test_bf16_flash_io_flavours_are_one_body(cuda):
    """K1b's bf16-I/O flavour gives the f32-I/O flavour's O on the upcast
    inputs rounded once and the same LSE, bit for bit, at the scoring
    shape's rows and the ring's edges: both run one bf16 body on one fold."""
    g = torch.Generator().manual_seed(7)
    for b, t, lengths in ((6, 511, [511, 499, 250, 64, 1, 0]), (4, 193, [193, 129, 128, 0])):
        q, k, v = (torch.randn(b, t, 12, 64, generator=g).to(cuda).to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
        o32, lse32 = flash_attention.mha_flash(q.float(), k.float(), v.float(), lens, "default")
        assert o.dtype == torch.bfloat16
        assert torch.equal(o, o32.to(torch.bfloat16)) and torch.equal(lse, lse32), t


def test_bf16_flash_occupancy(cuda):
    """K1b keeps on an SM the blocks its launch plan claims, both I/O
    flavours (a consumer warpgroup and a producer warp, 74,816 bytes of
    dynamic shared memory)."""
    plan = flash_attention.flash_bf16_launch_plan(511, 96, 12)
    for io in (False, True):
        assert flash_attention.flash_bf16_occupancy(io) >= plan["blocks_per_sm"], io


def test_bf16_precision_ops_and_refusals_on_the_card(cuda):
    """ops.precision's card routes (cuBLAS bf16 with f32 out; cuDNN f32 on
    bf16-rounded operands) against their plain versions on the CPU, within
    f32 summation order: the convolution's output is not rounded to bf16;
    their gradients too (JAX's DEFAULT transposes); a gradient through K1b
    runs K2b and K3b (it was refused before they were ported)."""
    g = torch.Generator().manual_seed(9)
    x, w, b = torch.randn(3, 37, 96, generator=g), torch.randn(80, 96, generator=g), torch.randn(80)
    y = prec_ops.linear(x.to(cuda), w.to(cuda), b.to(cuda), "default")
    torch.testing.assert_close(y.cpu(), prec_ops.linear(x, w, b, "default"), atol=2e-5, rtol=1e-5)
    xc, wc = torch.randn(2, 32, 70, generator=g), torch.randn(32, 8, 16, generator=g)
    kw = dict(padding=8, groups=4)
    yc = prec_ops.conv1d(xc.to(cuda), wc.to(cuda), None, "default", **kw).cpu()
    ref = prec_ops.conv1d(xc, wc, None, "default", **kw)
    torch.testing.assert_close(yc, ref, atol=2e-5, rtol=1e-5)
    assert not prec_ops.round_bf16(yc).equal(yc)  # an f32 output, as the TPU's
    # one cotangent for both devices, 2y of square().sum() taken once on
    # the CPU: each device's own 2y may round apart where y straddles a
    # bf16 boundary
    dy = 2 * prec_ops.linear(x, w, b, "default")
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [t.to(dev).requires_grad_() for t in (x, w, b)]
        prec_ops.linear(*xs, "default").backward(dy.to(dev))
        grads.append([t.grad.cpu() for t in xs])
    for ours, theirs in zip(*grads):
        torch.testing.assert_close(ours, theirs, atol=1e-4, rtol=1e-5)
    # the attention-shaped product: cuBLAS bmm of bf16 operands, f32 out
    a, c = torch.randn(2, 3, 37, 64, generator=g), torch.randn(2, 3, 64, 29, generator=g)
    dy = torch.randn(2, 3, 37, 29, generator=g)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        xs = [t.to(dev).requires_grad_() for t in (a, c)]
        y = prec_ops.matmul_bf16(*xs)
        y.backward(dy.to(dev))
        outs.append([y.detach().cpu()] + [t.grad.cpu() for t in xs])
    for ours, theirs in zip(*outs):
        assert ours.dtype == torch.float32
        torch.testing.assert_close(ours, theirs, atol=2e-5, rtol=1e-5)
    q = torch.randn(1, 10, 2, 64, device=cuda, requires_grad=True)
    lens = torch.tensor([10], dtype=torch.int32, device=cuda)
    out = flash_attention.FlashAttention.apply(q, q, q, lens, "default")
    before = (flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches_bwd_dq_bf16 - before[0],
            flash_attention.launches_bwd_dkv_bf16 - before[1]) == (1, 1)
    assert torch.isfinite(q.grad).all()


def attention_bwd_f64(q, k, v, do, lengths):
    """The exact gradient of masked attention in float64."""
    t, d = q.shape[1], q.shape[3]
    valid = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    vk = valid[:, :, None, None]
    qd, dod = q.double(), do.double()
    kd, vd = (torch.where(vk, x, 0.0).double() for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / d**0.5
    p = torch.softmax(s.masked_fill(~valid[:, None, None, :], float("-inf")), dim=-1)
    p = p.nan_to_num(0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd) / d**0.5,
            torch.where(vk, torch.einsum("bhqk,bqhd->bkhd", ds, qd) / d**0.5, 0.0),
            torch.where(vk, torch.einsum("bhqk,bqhd->bkhd", p, dod), 0.0))


# K2b/K3b against their plain version on the same inputs, for each output:
# max |d| relative to the plain version's max |g|, and ||d|| to its norm
# (chip_smoke.py's bounds: ~3x what an H100 gives on random inputs)
BWD_BF16_PLAIN_REL, BWD_BF16_PLAIN_NORM = 3.5e-3, 1e-3


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 511, 129, 193, 257])
def test_bf16_flash_backward_kernels_tile_edges(cuda, t):
    """K2b and K3b (the "default" flavour of K2/K3) against their plain
    version at every edge of their 16-row warp tiles and 64-row blocks and
    tiles and of their 3-stage ring (3, 4 and 5 tiles, the last one
    ragged), a full, a ragged, a 1-key and a 0-key row, NaN in k and v past
    each bound: dQ, dK and dV each within BWD_BF16_PLAIN_REL of the plain
    version's max |g| and BWD_BF16_PLAIN_NORM of its norm from it, and no
    further from the exact float64 gradient than 1.5 x the plain version's
    distance + 1e-6 (both round their operands to bf16; the sums differ in
    order); dK = dV = 0 past the bound, zero gradients for the 0-key row,
    a rerun the same bits."""
    lengths = [t, max(t // 2, 1), 1, 0]
    g = torch.Generator().manual_seed(t + 7)
    b, h, d = len(lengths), 4, 64
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(cuda)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    do = torch.randn(b, t, h, d, generator=g).to(cuda)
    before = [flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16,
              flash_attention.launches_bwd_fold_bf16, flash_attention.launches_bwd_dq,
              flash_attention.launches_bwd_dkv]
    ours = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "default")
    torch.cuda.synchronize()
    assert [flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16,
            flash_attention.launches_bwd_fold_bf16, flash_attention.launches_bwd_dq,
            flash_attention.launches_bwd_dkv] == [
        before[0] + 1, before[1] + 1, before[2] + 1, before[3], before[4]]
    plain = flash_attention.flash_attention_bwd_ref(q, k, v, o, lse, do, lens, "default")
    exact = attention_bwd_f64(q, k, v, do, lens)
    for a, p, e in zip(ours, plain, exact):
        assert torch.isfinite(a).all()
        assert (a - p).abs().max() <= BWD_BF16_PLAIN_REL * p.abs().max()
        assert (a - p).norm() <= BWD_BF16_PLAIN_NORM * p.norm()
        err, err_plain = (a.double() - e).abs().max().item(), (p.double() - e).abs().max().item()
        assert err <= 1.5 * err_plain + 1e-6, (err, err_plain)
    dq, dk, dv = ours
    for i, n in enumerate(lengths):
        assert torch.all(dk[i, n:] == 0) and torch.all(dv[i, n:] == 0)
    assert torch.all(dq[3] == 0)
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "default")
    assert all(torch.equal(a, c) for a, c in zip(ours, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_flash_backward_prologue_folds_the_operands(cuda, dtype):
    """K2b/K3b's prologue writes q, k, v and dO bit-equal to
    ``fold_bf16_ref`` (folded head-major to bf16 [B*H, T64, 64], k and v 0
    past each bound, NaN there included) and LSE and Di padded with zeros;
    a bf16 flavour's fold equals the f32 flavour's on the upcast inputs."""
    g = torch.Generator().manual_seed(3)
    b, t, h, lengths = 4, 130, 3, [130, 64, 1, 0]
    q, k, v, o, do = (torch.randn(b, t, h, 64, generator=g).to(cuda).to(dtype) for _ in range(5))
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    lse = torch.randn(b, h, t, generator=g).to(cuda)
    do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)
    before = (flash_attention.launches_bwd_fold_bf16, flash_attention.launches_bwd_fold_bf16_io)
    fold, ld = flash_attention._bwd_bf16_fold(q, k, v, do_, lse, di, lens_)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (flash_attention.launches_bwd_fold_bf16, flash_attention.launches_bwd_fold_bf16_io) == (
        before[0] + (not bf16), before[1] + bf16)
    for n, x in enumerate((q, k, v, do)):
        assert torch.equal(fold[n], flash_attention.fold_bf16_ref(x, lens, n in (1, 2))), n
    assert fold.shape == (4, b * h, 192, 64) and ld.shape == (2, b * h, 192)
    for n, x in enumerate((lse, di)):
        assert torch.equal(ld[n, :, :t], x.reshape(b * h, t)) and not ld[n, :, t:].any()
    if bf16:
        up = [x.float() for x in (q, k, v, do_)]
        fold32, ld32 = flash_attention._bwd_bf16_fold(*up[:3], up[3], lse, di, lens_)
        assert torch.equal(fold32, fold) and torch.equal(ld32, ld)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_flash_backward_one_call_is_the_kernels_alone(cuda, dtype):
    """``flash_attention_bwd``'s one C call (prologue, K2b, K3b) gives the
    bits of the three kernels launched one at a time, and counts one
    launch of each; a workspace made for another shape is refused."""
    g = torch.Generator().manual_seed(5)
    b, t, h, lengths = 4, 193, 2, [193, 100, 1, 0]
    q, k, v, do = (torch.randn(b, t, h, 64, generator=g).to(cuda).to(dtype) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    io = "_io" if dtype == torch.bfloat16 else ""
    names = [f"launches_bwd_{n}_bf16{io}" for n in ("fold", "dq", "dkv")]
    before = [getattr(flash_attention, n) for n in names]
    ours = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "default")
    assert [getattr(flash_attention, n) for n in names] == [c + 1 for c in before]
    do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)
    ws = flash_attention._bwd_bf16_fold(q, k, v, do_, lse, di, lens_)
    alone = (*flash_attention._bwd_bf16_kernel("dq", q, ws, lens_),
             *flash_attention._bwd_bf16_kernel("dkv", q, ws, lens_))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(ours, alone))
    with pytest.raises(ValueError, match="workspace"):
        flash_attention._bwd_bf16_kernel("dq", q[:, :64], ws, lens_)


def test_bf16_flash_backward_occupancy(cuda):
    """K2b keeps 3 blocks on an SM and K3b 2, both I/O flavours: what their
    launch plan claims (a consumer warpgroup and a producer warp, 68,152
    bytes of dynamic shared memory each)."""
    for kernel, plan in flash_attention.flash_bwd_bf16_launch_plan(499, 24, 12).items():
        for io in (False, True):
            assert flash_attention.flash_bwd_bf16_occupancy(kernel, io) >= (
                plan["blocks_per_sm"]), (kernel, io)


def test_loss_balanced_launches_k2b_k3b(cuda):
    """The loss in "balanced" on a narrow model with 64-wide heads: K1b in
    both forwards, K2b and K3b once per block in the backward, none of the
    f32 K1/K2/K3; a finite gradient that differs from "exact"'s."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    sd = init_weights(NomadModel(Wav2Vec2Config.tiny(**kw), emb_dim=16), seed=0).state_dict()
    g = torch.Generator().manual_seed(4)
    clean = 0.3 * torch.randn(4, 4000, generator=g)
    est = clean + 0.05 * torch.randn(4, 4000, generator=g)
    grads = {}
    for mode in ("exact", "balanced"):
        cfg = Wav2Vec2Config.tiny(**PRECISION_ISLANDS[mode], **kw)
        nomad = Nomad(device="cuda", config=cfg, emb_dim=16, params=sd)
        e = est.clone().requires_grad_()
        counts = [flash_attention.launches, flash_attention.launches_bf16,
                  flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv,
                  flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16]
        nomad.forward(e, clean).backward()
        torch.cuda.synchronize()
        now = [flash_attention.launches, flash_attention.launches_bf16,
               flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkv,
               flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16]
        delta = [a - b for a, b in zip(now, counts)]
        assert delta == ([4, 0, 2, 2, 0, 0] if mode == "exact" else [0, 4, 0, 0, 2, 2]), delta
        assert torch.isfinite(e.grad).all()
        grads[mode] = e.grad
    assert (grads["balanced"] - grads["exact"]).abs().max() > 0


def test_model_balanced_and_fast_launch_k1b(cuda):
    """A narrow model with 64-wide heads in "balanced" and "fast": K1b in
    every block and no K1, finite embeddings that differ from "exact" by
    bf16 rounding, not more."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    g = torch.Generator().manual_seed(5)
    lengths = torch.tensor([4000, 2500]).to(cuda)
    wav = (0.3 * torch.randn(2, 4000, generator=g)).to(cuda)
    sd = init_weights(NomadModel(Wav2Vec2Config.base(**kw), emb_dim=16), seed=2).state_dict()
    embs = {}
    for mode, cfg in (("exact", Wav2Vec2Config.base(**kw)),
                      ("balanced", Wav2Vec2Config.balanced(**kw)),
                      ("fast", Wav2Vec2Config.fast(**kw))):
        model = NomadModel(cfg, emb_dim=16)
        model.load_state_dict(sd)
        model = model.to(cuda).eval()
        before = (flash_attention.launches, flash_attention.launches_bf16)
        with torch.inference_mode():
            embs[mode] = model(wav, lengths)
        torch.cuda.synchronize()
        bf16 = mode != "exact"
        assert (flash_attention.launches - before[0], flash_attention.launches_bf16 - before[1]) == (
            (0, 12) if bf16 else (12, 0))
        assert torch.isfinite(embs[mode]).all()
    for mode in ("balanced", "fast"):
        d = (embs[mode] - embs["exact"]).abs().max().item()
        assert 0 < d < 1e-2, (mode, d)


# ---------------- K4b: the fused path at "default" ----------------


def fused_f64(x, params, lengths, heads):
    """K4b's oracle: float64 projections of the bf16-rounded x and weights
    plus the biases, then exact attention in float64; head-major."""
    b, t, _ = x.shape
    xd = prec_ops.round_bf16(x).double()
    q, k, v = (torch.nn.functional.linear(xd, prec_ops.round_bf16(w).double(), bias.double())
               .view(b, t, heads, 64) for w, bias in zip(params[0::2], params[1::2]))
    return attention_f64(q, k, v, lengths).transpose(1, 2)


@pytest.mark.parametrize("t", [1, 15, 17, 64, 65, 511, 1023, 1024])
def test_bf16_fused_kernel_matches_ref(cuda, t):
    """K4b against its plain version at "default": one launch (and no K4),
    every row finite, a 0-key row 0, O no further from ``fused_f64`` than
    1.5 x the plain version's distance + 1e-6, K1b fed by the "default"
    projections of the same x no further from K4b than the two plain
    versions are from each other (+ 1e-6), a rerun the same bits; NaN past
    each bound changes no valid row, 123.0 there leaves every row finite."""
    lengths = [t, max(t // 2, 1), 1, 0]
    x, params = _fused_inputs(cuda, len(lengths), t, 2, 200 + t)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = (fused_attention.launches, fused_attention.launches_bf16)
    o = fused_attention.fused_qkv_mha(x, *params, lens, 2, "default")
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention.launches_bf16) == (before[0], before[1] + 1)
    assert o.shape == (4, 2, t, 64) and torch.isfinite(o).all()
    assert torch.equal(o[3], torch.zeros_like(o[3]))
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, 2, "default")
    exact = fused_f64(x, params, lens, 2)
    err, err_plain = ((a.double() - exact).abs().max().item() for a in (o, ref))
    assert err <= 1.5 * err_plain + 1e-6, (err, err_plain)
    q, k, v = (prec_ops.linear(x, w, bias, "default").view(4, t, 2, 64)
               for w, bias in zip(params[0::2], params[1::2]))
    o_k1b = flash_attention.mha_flash(q, k, v, lens, "default")[0].transpose(1, 2)
    o_pair = flash_attention.flash_attention_ref(q, k, v, lens, "default")[0].transpose(1, 2)
    assert (o - o_k1b).abs().max() <= (ref - o_pair).abs().max() + 1e-6
    assert torch.equal(fused_attention.fused_qkv_mha(x, *params, lens, 2, "default"), o)
    for fill, whole in ((float("nan"), False), (123.0, True)):
        dirty = x.clone()
        for i, n in enumerate(lengths):
            dirty[i, n:] = fill
        got = fused_attention.fused_qkv_mha(dirty, *params, lens, 2, "default")
        assert not whole or torch.isfinite(got).all()
        for i, n in enumerate(lengths):
            assert torch.equal(got[i, :, :n], o[i, :, :n]), (fill, i)


def test_bf16_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """At "default" a CUDA tensor launches K4b or raises: never K4, never
    the plain version."""
    x, params = _fused_inputs(cuda, 2, 40, 2, 17)
    lens = torch.tensor([40, 20], dtype=torch.int32, device=cuda)
    before = (fused_attention.launches, fused_attention.launches_bf16)
    with pytest.raises(ValueError, match="head width"):
        fused_attention.fused_qkv_mha(x, *params, lens, 4, "default")
    xl, pl = _fused_inputs(cuda, 1, 1025, 2, 18)
    with pytest.raises(ValueError, match="1024"):
        fused_attention.fused_qkv_mha(xl, *pl, lens[:1], 2, "default")
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention.fused_qkv_mha(x.transpose(0, 1).contiguous().transpose(0, 1),
                                      *params, lens, 2, "default")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention.fused_qkv_mha(x.half(), *params, lens, 2, "default")
    with pytest.raises(TypeError, match="float32"):  # a bf16 x takes the f32 weights
        fused_attention.fused_qkv_mha(x.to(torch.bfloat16), *(a.to(torch.bfloat16)
                                                               for a in params), lens, 2,
                                      "default")
    with pytest.raises(ValueError, match="lengths"):
        fused_attention.fused_qkv_mha(x, *params, lens.long(), 2, "default")
    with pytest.raises(ValueError, match="is on"):
        fused_attention.fused_qkv_mha(x, params[0].cpu(), *params[1:], lens, 2, "default")
    with pytest.raises(ValueError, match="precision"):
        fused_attention.fused_qkv_mha(x, *params, lens, 2, "bf16")
    assert (fused_attention.launches, fused_attention.launches_bf16) == before


def test_bf16_fused_gradient_matches_the_unfused_default_autograd(cuda):
    """FusedQKVAttention at "default" (K4b forward; K1b recompute, K2b +
    K3b backward) against autograd through the unfused "default"
    composition on the card, ``precision.linear`` + ``FlashAttention``:
    the backward recomputes the same products, so the gradients agree to
    f32 order."""
    x, params = _fused_inputs(cuda, 3, 130, 2, 19)
    lens = torch.tensor([130, 77, 1], dtype=torch.int32, device=cuda)
    do = torch.randn(3, 2, 130, 64, generator=torch.Generator().manual_seed(20)).to(cuda)
    ours = [a.clone().requires_grad_() for a in (x, *params)]
    theirs = [a.clone().requires_grad_() for a in (x, *params)]
    counts = lambda: (fused_attention.launches_bf16, flash_attention.launches_bf16,  # noqa: E731
                      flash_attention.launches_bwd_dq_bf16, flash_attention.launches_bwd_dkv_bf16,
                      fused_attention.launches, flash_attention.launches)
    before = counts()
    o = fused_attention.FusedQKVAttention.apply(*ours, lens, 2, "default")
    o.backward(do)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before[:4]) + before[4:]
    q, k, v = (prec_ops.linear(theirs[0], theirs[i], theirs[i + 1], "default").view(3, 130, 2, 64)
               for i in (1, 3, 5))
    flash_attention.FlashAttention.apply(q, k, v, lens, "default").transpose(1, 2).backward(do)
    for a, r in zip(ours, theirs):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad, r.grad, atol=1e-5 * r.grad.abs().max().item(), rtol=0)


def test_model_fast_fused_path_launches_k4b(cuda):
    """A narrow model with 64-wide heads in "fast" with ``fused_qkv``: K4b
    in every block and no K1b, K1 or K4; embeddings no further from the
    "fast" K1b path than half of that path's distance to "exact" (the
    same bf16 roundings); "balanced" with ``fused_qkv`` runs K4h, the
    "high" of "exact"."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    g = torch.Generator().manual_seed(6)
    lengths = torch.tensor([4000, 2500]).to(cuda)
    wav = (0.3 * torch.randn(2, 4000, generator=g)).to(cuda)
    sd = init_weights(NomadModel(Wav2Vec2Config.base(**kw), emb_dim=16), seed=3).state_dict()
    embs, launched = {}, {}
    for name, cfg in (("exact", Wav2Vec2Config.base(**kw)),
                      ("fast", Wav2Vec2Config.fast(**kw)),
                      ("fast_fused", Wav2Vec2Config.fast(attention_impl="fused_qkv", **kw)),
                      ("balanced_fused", Wav2Vec2Config.balanced(attention_impl="fused_qkv", **kw))):
        model = NomadModel(cfg, emb_dim=16)
        model.load_state_dict(sd)
        model = model.to(cuda).eval()
        counters = (lambda: (fused_attention.launches_bf16, fused_attention.launches,  # noqa: E731
                             flash_attention.launches_bf16, flash_attention.launches,
                             fused_attention.launches_high3))
        before = counters()
        with torch.inference_mode():
            embs[name] = model(wav, lengths)
        torch.cuda.synchronize()
        launched[name] = tuple(a - b for a, b in zip(counters(), before))
        assert torch.isfinite(embs[name]).all()
    assert launched["fast_fused"] == (12, 0, 0, 0, 0)
    assert launched["balanced_fused"] == (0, 0, 0, 0, 12)
    d = (embs["fast_fused"] - embs["fast"]).abs().max().item()
    assert d <= 0.5 * (embs["fast"] - embs["exact"]).abs().max().item(), d


def test_bf16_fused_occupancy(cuda):
    """K4b, both I/O flavours, keeps at least the 2 blocks per SM it is
    built for (FUSED_BF16_BLOCKS_PER_SM: its shared memory and a consumer
    warpgroup plus a producer warp) at every cluster size of its plan, 3
    (T <= 64) and 2 .. 16, and each cluster size fits on the card."""
    for t in [50] + [64 * c for c in range(2, fused_attention.MAX_CLUSTER + 1)]:
        for io in (False, True):
            blocks, clusters = fused_attention.fused_occupancy(t, "default", io)
            assert blocks >= fused_attention.FUSED_BF16_BLOCKS_PER_SM and clusters >= 1, (
                t, io, blocks, clusters)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_fused_prologue_packs_the_weights(cuda, dtype):
    """K4b's prologue writes the packed weights bit-equal to
    ``pack_weights_ref`` (the JAX package's per_head_w layout, rounded) and,
    for an f32 x, x rounded to bf16; a bf16 x needs no copy."""
    x, params = _fused_inputs(cuda, 2, 70, 2, 23)
    x = x.to(dtype)
    lens = torch.tensor([70, 33], dtype=torch.int32, device=cuda)
    wp, xr = fused_attention._bf16_workspace(x, 2)
    fused_attention._launch("default", x, *params, lens, 2, workspace=(wp, xr))
    torch.cuda.synchronize()
    assert torch.equal(wp, fused_attention.pack_weights_ref(*params[0::2], 2))
    assert (xr is None) == (dtype == torch.bfloat16)
    if xr is not None:
        assert torch.equal(xr, x.to(torch.bfloat16))


# ---------------- K4h: the fused path at "high" (the TPU kernel's "high3") ----------------


def fused_f64_unrounded(x, params, lengths, heads):
    """K4h's oracle: float64 projections of the unrounded x and weights plus
    the biases, then exact attention in float64; head-major."""
    b, t, _ = x.shape
    q, k, v = (torch.nn.functional.linear(x.double(), w.double(), bias.double())
               .view(b, t, heads, 64) for w, bias in zip(params[0::2], params[1::2]))
    return attention_f64(q, k, v, lengths).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 17, 64, 65, 130, 511, 1024])
def test_high3_fused_kernel_matches_ref(cuda, t, dtype):
    """K4h (f32 x) and K4h-bf16 against their plain version at "high": one
    launch of the flavour's own counter (and no K4 or K4b), every row
    finite, a 0-key row 0; f32 x: within K4's 2e-5 + 1e-5 relative (f32
    sums in another order), and O no further from ``fused_f64_unrounded``
    than 1.5 x the plain version's distance + 1e-6 and no nearer than half
    of it (both drop every lo.lo term); bf16 x: the f32 flavour's O on the
    upcast x rounded once, bit for bit; a rerun the same bits; NaN past
    each bound changes no valid row, 123.0 there leaves every row finite."""
    lengths = [t, max(t // 2, 1), 1, 0]
    x, params = _fused_inputs(cuda, len(lengths), t, 2, 300 + t)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    bf16 = dtype == torch.bfloat16
    counters = lambda: (fused_attention.launches_high3,  # noqa: E731
                        fused_attention.launches_high3_bf16_io, fused_attention.launches,
                        fused_attention.launches_bf16)
    before = counters()
    o = fused_attention.fused_qkv_mha(x, *params, lens, 2, "high")
    torch.cuda.synchronize()
    assert counters() == (before[0] + (not bf16), before[1] + bf16, *before[2:])
    assert o.shape == (4, 2, t, 64) and o.dtype == dtype and torch.isfinite(o).all()
    assert torch.equal(o[3], torch.zeros_like(o[3]))
    if bf16:
        assert torch.equal(o, fused_attention.fused_qkv_mha(x.float(), *params, lens, 2,
                                                            "high").to(dtype))
    else:
        ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, 2, "high")
        torch.testing.assert_close(o, ref, atol=2e-5, rtol=1e-5)
        exact = fused_f64_unrounded(x, params, lens, 2)
        err, err_plain = ((a.double() - exact).abs().max().item() for a in (o, ref))
        assert 0.5 * err_plain <= err <= 1.5 * err_plain + 1e-6, (err, err_plain)
    assert torch.equal(fused_attention.fused_qkv_mha(x, *params, lens, 2, "high"), o)
    for fill, whole in ((float("nan"), False), (123.0, True)):
        dirty = x.clone()
        for i, n in enumerate(lengths):
            dirty[i, n:] = fill
        got = fused_attention.fused_qkv_mha(dirty, *params, lens, 2, "high")
        assert not whole or torch.isfinite(got).all()
        for i, n in enumerate(lengths):
            assert torch.equal(got[i, :, :n], o[i, :, :n]), (fill, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_high3_fused_prologue_splits_the_operands(cuda, dtype):
    """K4h's prologue writes the packed weights' hi and lo planes bit-equal
    to ``pack_weights_ref(..., planes=2)`` and, for an f32 x, x's planes
    bit-equal to ``precision.split_bf16``; a bf16 x needs no copy."""
    x, params = _fused_inputs(cuda, 2, 70, 2, 24)
    x = x.to(dtype)
    lens = torch.tensor([70, 33], dtype=torch.int32, device=cuda)
    wp, xr = fused_attention._bf16_workspace(x, 2, planes=2)
    fused_attention._launch("high", x, *params, lens, 2, workspace=(wp, xr))
    torch.cuda.synchronize()
    assert torch.equal(wp, fused_attention.pack_weights_ref(*params[0::2], 2, planes=2))
    assert (xr is None) == (dtype == torch.bfloat16)
    if xr is not None:
        assert torch.equal(xr, torch.cat(prec_ops.split_bf16(x)).to(torch.bfloat16))


def test_high3_fused_occupancy_and_route(cuda):
    """K4h, both I/O flavours, keeps the 1 block per SM it is built for at
    every cluster size of its plan and each size fits on the card; the
    narrow model on the fused path at its default "high" launches K4h once
    per block (no K4, K1) and its embeddings lie within 1e-5 of the same
    model with the fused kernel's plain version."""
    for t in [50] + [64 * c for c in range(2, fused_attention.MAX_CLUSTER + 1)]:
        for io in (False, True):
            blocks, clusters = fused_attention.fused_occupancy(t, "high", io)
            assert blocks >= fused_attention.FUSED_HIGH3_BLOCKS_PER_SM and clusters >= 1, (
                t, io, blocks, clusters)
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv", **kw),
                                    emb_dim=16), seed=0).to(cuda).eval()
    g = torch.Generator().manual_seed(4)
    lengths = torch.tensor([4000, 2500, 900]).to(cuda)
    wav = (0.3 * torch.randn(3, 4000, generator=g)).to(cuda)
    counts = lambda: (fused_attention.launches_high3, fused_attention.launches,  # noqa: E731
                      flash_attention.launches)
    before = counts()
    with torch.inference_mode():
        emb = model(wav, lengths)
        assert tuple(a - b for a, b in zip(counts(), before)) == (2, 0, 0)
        real = fused_attention.fused_qkv_mha
        fused_attention.fused_qkv_mha = fused_attention.fused_qkv_attention_ref
        try:
            plain = model(wav, lengths)
        finally:
            fused_attention.fused_qkv_mha = real
    torch.testing.assert_close(emb, plain, atol=1e-5, rtol=0)


# ---------------- the bf16-I/O flavours (the trainer's fast_bf16) ----------------


@pytest.mark.parametrize("rows,width", [(1001, 768), (333, 512)])
def test_bf16_io_layer_norm_is_the_f32_flavour_rounded(cuda, rows, width):
    """K5's bf16-I/O flavour equals its f32 flavour on the upcast rows,
    rounded once, bit for bit (a lane holds the same elements in both, so
    the f32 statistics sum in the same order), and counts its own
    launches."""
    g = torch.Generator().manual_seed(rows)
    x = (3 * torch.randn(rows, width, generator=g) + 1).to(cuda).to(torch.bfloat16)
    w, b = (torch.randn(width, generator=g).to(cuda) for _ in range(2))
    before = (layernorm.launches, layernorm.launches_bf16_io)
    out = layernorm.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert (layernorm.launches, layernorm.launches_bf16_io) == (before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, layernorm.layer_norm(x.float(), w, b).to(torch.bfloat16))


@pytest.mark.parametrize("b,t,lengths", [(4, 65, [65, 32, 1, 0]), (3, 499, [499, 250, 17])])
def test_bf16_io_flash_kernels_are_the_f32_flavour_rounded(cuda, b, t, lengths):
    """K1b's, K2b's and K3b's bf16-I/O flavours on bf16 q, k, v, dO (views
    of one buffer, NaN past each bound) equal their f32-I/O flavour on the
    upcast inputs, rounded once, bit for bit (LSE equal), and count their
    own launches."""
    g = torch.Generator().manual_seed(t)
    bf = torch.bfloat16
    qkv = torch.randn(b, t, 3, 4, 64, generator=g).to(cuda).to(bf)
    q, k, v = qkv.unbind(2)
    for i, n in enumerate(lengths):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    do = torch.randn(b, t, 4, 64, generator=g).to(cuda).to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = (flash_attention.launches_bf16_io, flash_attention.launches_bwd_dq_bf16_io,
              flash_attention.launches_bwd_dkv_bf16_io, flash_attention.launches_bf16)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "default")
    grads = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "default")
    torch.cuda.synchronize()
    after = (flash_attention.launches_bf16_io, flash_attention.launches_bwd_dq_bf16_io,
             flash_attention.launches_bwd_dkv_bf16_io, flash_attention.launches_bf16)
    assert tuple(a - c for a, c in zip(after, before)) == (1, 1, 1, 0)
    up = [x.float() for x in (q, k, v)]
    o32, lse32 = flash_attention.mha_flash(*up, lens, "default")
    assert o.dtype == bf and torch.equal(o, o32.to(bf)) and torch.equal(lse, lse32)
    grads32 = flash_attention.flash_attention_bwd(*up, o.float(), lse, do.float(), lens,
                                                  "default")
    for ours, theirs in zip(grads, grads32):
        assert ours.dtype == bf and torch.equal(ours, theirs.to(bf))


def test_f32_kernels_refuse_bf16(cuda):
    """The forward and the backward at "highest" (f32 products) take bf16
    tensors through K1-bf16 and K2-bf16/K3-bf16 (their own launch counters,
    never K1b's or K1's); they refuse float16 and q, k and v of mixed
    dtypes with TypeError."""
    q = torch.randn(1, 10, 2, 64, device=cuda, dtype=torch.bfloat16)
    lens = torch.tensor([10], dtype=torch.int32, device=cuda)
    lse = torch.zeros(1, 2, 10, device=cuda)
    for bad in ((q.half(),) * 3, (q, q.float(), q)):
        with pytest.raises(TypeError, match="must be"):
            flash_attention.mha_flash(*bad, lens, "highest")
        with pytest.raises(TypeError, match="must be"):
            flash_attention.flash_attention_bwd(*bad, q, lse, q, lens, "highest")
    before = (flash_attention.launches_f32_bf16_io, flash_attention.launches_bwd_dq_f32_bf16_io,
              flash_attention.launches_bwd_dkv_f32_bf16_io, flash_attention.launches_bf16_io,
              flash_attention.launches)
    o, lse = flash_attention.mha_flash(q, q, q, lens, "highest")
    flash_attention.flash_attention_bwd(q, q, q, o, lse, q, lens, "highest")
    torch.cuda.synchronize()
    after = (flash_attention.launches_f32_bf16_io, flash_attention.launches_bwd_dq_f32_bf16_io,
             flash_attention.launches_bwd_dkv_f32_bf16_io, flash_attention.launches_bf16_io,
             flash_attention.launches)
    assert o.dtype == torch.bfloat16
    assert tuple(x - y for x, y in zip(after, before)) == (1, 1, 1, 0, 0)


BF16_STEP = 2.0 ** -7  # one bf16 step, relative to a value's magnitude (upper bound)
BWD_F32_REL, BWD_NOISE = 1e-4, 1e-4  # f32 sums in two orders; an output that is noise


def bf16_step(x):
    """One bf16 step at each |x| (8 significant bits), in f32."""
    mag = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def assert_highest_bf16_backward(q, k, v, o, lse, do, lens, grads):
    """K2-bf16's and K3-bf16's gradients (the "highest" backward on bf16
    tensors, f32-exact products summed in the tensor core's order), each
    (a) element within one bf16 step (at the larger of the two) beyond
    1e-4 of max |g| of the f32 flavour's on the upcast inputs, rounded once
    (both sum f32-exact products, in two orders); (b) within one bf16 step
    (2^-7 of each output's max) plus 1e-4 of it of their plain version on
    the same bf16 inputs; (c) no further from the exact float64 gradient
    than 1.5 x the plain version's distance + 1e-6 + one bf16 step of the
    output; (d) a rerun the same bits, and NaN past each bound changing no
    valid row (every dQ row, dK and dV below each bound). An output that
    is rounding noise (max |g| <= 1e-4: dQ and dK with one key) is held by
    (c) alone. Returns the share of elements that differ from (a)'s
    rounded f32 flavour."""
    bf = torch.bfloat16
    up = [x.float() for x in (q, k, v)]
    grads32 = flash_attention.flash_attention_bwd(*up, o.float(), lse, do.float(), lens,
                                                  "highest")
    refs = flash_attention.flash_attention_bwd_ref(q, k, v, o, lse, do, lens, "highest")
    exact = attention_bwd_f64(*up, do.float(), lens)
    shares = []
    for ours, g32, ref, x in zip(grads, grads32, refs, exact):
        assert ours.dtype == bf and torch.isfinite(ours).all()
        g32b = g32.to(bf)
        diff = (ours.float() - g32b.float()).abs()
        gmax = g32.abs().max().item()
        if gmax > BWD_NOISE:
            step = bf16_step(torch.maximum(ours.float().abs(), g32b.float().abs()))
            assert (diff <= step + BWD_F32_REL * gmax).all()  # (a)
            scale = ref.float().abs().max().item()
            assert (ours.float() - ref.float()).abs().max().item() <= (  # (b)
                BF16_STEP + BWD_F32_REL) * scale
        shares.append((ours != g32b).float().mean().item())
        err = (ours.double() - x).abs().max().item()  # (c)
        err_plain = (ref.double() - x).abs().max().item()
        assert err <= 1.5 * err_plain + 1e-6 + BF16_STEP * x.abs().max().item(), (err, err_plain)
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "highest")
    assert all(torch.equal(a, c) for a, c in zip(grads, again))  # (d)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lens.tolist()):
        k2[i, n:] = float("nan")
        v2[i, n:] = float("nan")
    dq2, dk2, dv2 = flash_attention.flash_attention_bwd(q, k2, v2, o, lse, do, lens, "highest")
    assert torch.equal(dq2, grads[0])
    for i, n in enumerate(lens.tolist()):
        assert torch.equal(dk2[i, :n], grads[1][i, :n]) and torch.equal(dv2[i, :n], grads[2][i, :n])
        assert not dk2[i, n:].any() and not dv2[i, n:].any()
    return shares


FWD_F32_REL = 1e-4  # K1-bf16 and K4-bf16 against the f32 flavour: two f32 orders


def assert_near_f32_flavour(o, o32):
    """Every element of a "highest" bf16 forward's O (K1-bf16, K4-bf16)
    within one bf16 step (at the larger of the two) beyond 1e-4 of max |O|
    of the f32 flavour's O on the upcast inputs, rounded once: both sum
    f32-exact products, in two orders. Returns the share of elements that
    differ."""
    o32b = o32.to(torch.bfloat16)
    diff = (o.float() - o32b.float()).abs()
    step = bf16_step(torch.maximum(o.float().abs(), o32b.float().abs()))
    assert (diff <= step + FWD_F32_REL * o32.abs().max().item()).all()
    return (o != o32b).float().mean().item()


def lse_f64(q, k, lengths):
    """The exact log-sum-exp of q's scores over each row's valid keys, in
    float64 [B, H, T]; -1e30 for a row with no key."""
    b, t, h, d = q.shape
    valid = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / d**0.5, k.double())
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    out = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(out), out, torch.full_like(out, flash_attention.NEG_INF))


def check_highest_bf16_flash(cuda, lengths, t, h, seed, bwd=True):
    """K1-bf16 ("highest" on bf16 tensors: K1's products on the tensor
    cores): O bf16 within one bf16 step of K1's on the upcast inputs
    rounded once beyond 1e-4 of its max |O| (``assert_near_f32_flavour``),
    LSE no further from float64 than K1's x 1.5 + 1e-6, O no further from
    exact f64 attention than 1.5 x the plain version's distance + 1.5 bf16
    steps of its max + 1e-6; one launch of K1-bf16 and of the bf16
    prologue, none of K1, K1b; a 0-key row O = 0 and LSE = -1e30; a rerun
    the same bits; NaN past each bound changes no row. With ``bwd`` the
    backward, K2-bf16 and K3-bf16, by ``assert_highest_bf16_backward``.
    Returns the share of O's elements that differ from K1's rounded."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    b = len(lengths)
    q, k, v = torch.randn(b, t, 3, h, 64, generator=g).to(cuda).to(bf).unbind(2)
    do = torch.randn(b, t, h, 64, generator=g).to(cuda).to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    names = ("launches_f32_bf16_io", "launches_fwd_fold_bf16_io", "launches", "launches_bf16",
             "launches_bf16_io", "launches_fwd_fold_bf16")
    before = [getattr(flash_attention, n) for n in names]
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    torch.cuda.synchronize()
    assert [getattr(flash_attention, n) - c for n, c in zip(names, before)] == [1, 1, 0, 0, 0, 0]
    assert o.dtype == bf and torch.isfinite(o).all() and torch.isfinite(lse).all()
    up = [x.float() for x in (q, k, v)]
    o32, lse32 = flash_attention.mha_flash(*up, lens, "highest")
    share = assert_near_f32_flavour(o, o32)
    exact_lse = lse_f64(*up[:2], lens)
    gap, gap32 = ((x.double() - exact_lse).abs().max().item() for x in (lse, lse32))
    assert gap <= 1.5 * gap32 + 1e-6, (gap, gap32)
    ro, _ = flash_attention.flash_attention_ref(q, k, v, lens, "highest")
    exact = attention_f64(*up, lens)
    err, err_plain = ((x.double() - exact).abs().max().item() for x in (o, ro))
    assert err <= 1.5 * err_plain + 1.5 * BF16_STEP * exact.abs().max().item() + 1e-6
    for i, n in enumerate(lengths):
        if n == 0:
            assert not o[i].any() and (lse[i] == flash_attention.NEG_INF).all()
    again = flash_attention.mha_flash(q, k, v, lens, "highest")
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        k2[i, n:] = float("nan")
        v2[i, n:] = float("nan")
    o2, lse2 = flash_attention.mha_flash(q, k2, v2, lens, "highest")
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    if bwd:
        grads = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "highest")
        assert_highest_bf16_backward(q, k, v, o, lse, do, lens, grads)
    return share


@pytest.mark.parametrize("t,lengths", [(50, [50, 31, 1, 0]), (511, [511, 499, 64, 0]),
                                       (65, [65, 64, 1, 0])])
def test_highest_bf16_flash_within_one_step_of_f32_flavour(cuda, t, lengths):
    """K1-bf16, the "highest" forward on bf16 tensors on the tensor cores
    (K1's products, summed in the tensor core's order), and its backward,
    K2-bf16 and K3-bf16, by ``check_highest_bf16_flash``'s rules: within
    one bf16 step of the f32 flavour rounded once, near float64, a rerun
    the same bits, NaN past each bound changing nothing."""
    check_highest_bf16_flash(cuda, lengths, t, 4, t)


@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 511] + K1B_RING_EDGES)
def test_highest_bf16_flash_tile_and_ring_edges(cuda, t):
    """K1-bf16 at every edge of its 16-row warp tiles, 64-row blocks and
    64-key tiles and of its ring of 4 (K, V) stages, a full, a ragged, a
    1-key and a 0-key row, by ``check_highest_bf16_flash``'s rules."""
    check_highest_bf16_flash(cuda, [t, max(t // 2, 1), 1, 0], t, 4, 800 + t, bwd=False)


def test_highest_bf16_flash_one_call_is_the_prologue_and_kernel_alone(cuda):
    """``mha_flash``'s one C call at "highest" on bf16 tensors (the
    prologue, K1-bf16) gives the bits of the two launched one at a time,
    on a fold bit-equal to ``fold_bf16_ref``'s; f32 tensors are refused
    (they run K1), and so is a plan of another flavour's blocks."""
    g = torch.Generator().manual_seed(9)
    b, t, h, lengths = 4, 257, 3, [257, 130, 1, 0]
    q, k, v = (torch.randn(b, t, h, 64, generator=g).to(cuda).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    ws = flash_attention._flash_bf16_fold(q, k, v, lens)
    before = flash_attention.launches_f32_bf16_io
    alone = flash_attention._flash_bf16_body(q, ws, lens, "highest")
    torch.cuda.synchronize()
    assert flash_attention.launches_f32_bf16_io == before + 1
    for n, x in enumerate((k, v)):
        assert torch.equal(ws[n], flash_attention.fold_bf16_ref(x, lens, True)), n
    assert torch.equal(alone[0], o) and torch.equal(alone[1], lse)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention._flash_bf16_body(q.float(), ws, lens, "highest")
    lib = flash_attention._lib_bf16()
    plan = flash_attention.flash_bf16_launch_plan(t, b, h, "highest")
    for bad in ({"passes": 3, "bf16_io": 0}, {"passes": 2, "bf16_io": 1}):
        err = lib.nomad_flash_attention_bf16_fwd_kernel(
            q.data_ptr(), ws.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(), b, t, h,
            64, *q.stride()[:3], *o.stride()[:3], plan["rows_per_block"], plan["threads"],
            plan["smem_bytes"], plan["stages"], 0.125, bad["bf16_io"], bad["passes"],
            torch.cuda.current_stream().cuda_stream)
        assert err != 0, bad


def test_highest_bf16_flash_occupancy(cuda):
    """K1-bf16 keeps on an SM the 2 blocks its launch plan claims (K1b's
    block with three planes of P); the f32 I/O is no flavour of its."""
    plan = flash_attention.flash_bf16_launch_plan(511, 96, 12, "highest")
    assert plan["passes"] == 3 and plan["blocks_per_sm"] == 2
    assert flash_attention.flash_bf16_occupancy(True, "highest") >= plan["blocks_per_sm"]
    with pytest.raises(RuntimeError, match="occupancy"):
        flash_attention.flash_bf16_occupancy(False, "highest")


@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 257])
def test_highest_bf16_backward_tile_and_ring_edges(cuda, t):
    """K2-bf16 and K3-bf16 at every edge of their 64-row blocks and tiles
    and of their 3-stage ring (3, 4 and 5 tiles, the last one ragged), a
    full, a ragged, a 1-key and a 0-key row: by
    ``assert_highest_bf16_backward``'s rules, zero gradients for the 0-key
    row, and one launch each of K2-bf16, K3-bf16 and the bf16 prologue
    (its counter is K2b-bf16's: one kernel), none of K2, K3, K2b or K3b."""
    lengths = [t, max(t // 2, 1), 1, 0]
    g = torch.Generator().manual_seed(t + 11)
    bf = torch.bfloat16
    q, k, v = torch.randn(4, t, 3, 4, 64, generator=g).to(cuda).to(bf).unbind(2)
    do = torch.randn(4, t, 4, 64, generator=g).to(cuda).to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    names = ("launches_bwd_dq_f32_bf16_io", "launches_bwd_dkv_f32_bf16_io",
             "launches_bwd_fold_bf16_io", "launches_bwd_dq", "launches_bwd_dkv",
             "launches_bwd_dq_bf16_io", "launches_bwd_dkv_bf16_io", "launches_bwd_fold_bf16")
    before = [getattr(flash_attention, n) for n in names]
    grads = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "highest")
    torch.cuda.synchronize()
    assert [getattr(flash_attention, n) - c for n, c in zip(names, before)] == [1, 1, 1] + [0] * 5
    assert all(not x[3].any() for x in grads)
    assert_highest_bf16_backward(q, k, v, o, lse, do, lens, grads)


def test_highest_bf16_backward_one_call_is_the_kernels_alone(cuda):
    """``flash_attention_bwd``'s one C call at "highest" on bf16 tensors
    (the prologue, K2-bf16, K3-bf16) gives the bits of the three kernels
    launched one at a time; a workspace made for another shape is refused,
    and so are f32 tensors (they run K2 and K3) and a flavour the launch
    plan does not claim."""
    g = torch.Generator().manual_seed(6)
    b, t, h, lengths = 4, 193, 2, [193, 100, 1, 0]
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(b, t, h, 64, generator=g).to(cuda).to(bf) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = flash_attention.mha_flash(q, k, v, lens, "highest")
    ours = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, lens, "highest")
    do_, di, lens_ = flash_attention._bwd_args(q, k, v, o, lse, do, lens)
    ws = flash_attention._bwd_bf16_fold(q, k, v, do_, lse, di, lens_)
    alone = (*flash_attention._bwd_bf16_kernel("dq", q, ws, lens_, "highest"),
             *flash_attention._bwd_bf16_kernel("dkv", q, ws, lens_, "highest"))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(ours, alone))
    with pytest.raises(ValueError, match="workspace"):
        flash_attention._bwd_bf16_kernel("dkv", q[:, :128], ws, lens_, "highest")
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention._bwd_bf16_kernel("dq", q.float(), ws, lens_, "highest")
    with pytest.raises(TypeError, match="float32"):
        flash_attention._bwd_dq_kernel(q, k, v, do_, lse, di, lens_)
    # the C launcher checks the plan's blocks per SM against the kernel's own
    lib = flash_attention._lib_bwd_bf16()
    plan = flash_attention.flash_bwd_bf16_launch_plan(t, b, h, "highest")["dq"]
    dq = torch.empty_like(q)
    err = lib.nomad_flash_attention_bwd_bf16_dq(
        *(x.data_ptr() for x in ws), lens_.data_ptr(), dq.data_ptr(), b, t, h, 64,
        plan["rows_per_block"], plan["threads"], plan["smem_bytes"], plan["blocks_per_sm"] + 1,
        0.125, 1, 3, torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_highest_bf16_backward_occupancy(cuda):
    """K2-bf16 keeps 2 blocks on an SM and K3-bf16 1: what their launch
    plan claims (K2b/K3b's blocks, with the planes of dS and P and a stage
    accumulator in registers); the f32 I/O is no flavour of theirs."""
    for kernel, plan in flash_attention.flash_bwd_bf16_launch_plan(499, 24, 12, "highest").items():
        assert plan["passes"] == 3
        assert flash_attention.flash_bwd_bf16_occupancy(kernel, True, "highest") >= (
            plan["blocks_per_sm"]), kernel
        with pytest.raises(RuntimeError, match="occupancy"):
            flash_attention.flash_bwd_bf16_occupancy(kernel, False, "highest")


@pytest.mark.parametrize("prec", ["default", "high"])
@pytest.mark.parametrize("t,lengths", [(50, [50, 31, 1, 0]), (511, [511, 499, 64, 0]),
                                       (1024, [1024, 700, 1])])
def test_fused_bf16_io_flavours_bit_equal(cuda, prec, t, lengths):
    """K4h's ("high") and K4b's ("default") bf16-I/O flavours on a bf16 x
    with the f32 weights: O bf16, the f32-I/O flavour's O on the upcast x
    rounded once, bit for bit, counted by their own launch counters; within
    one bf16 step (2^-7 of max |O|) plus the f32-I/O flavour's own
    tolerance of their plain version; a 0-key row O = 0; garbage past each
    bound changes no valid row. "highest" on a bf16 x, K4-bf16, sums in
    another order than its f32 flavour: ``check_highest_bf16_fused``."""
    x, params = _fused_inputs(cuda, len(lengths), t, 2, t + 1)
    bf = torch.bfloat16
    x = x.to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    counter = {"default": "launches_bf16_io", "high": "launches_high3_bf16_io"}[prec]
    before = getattr(fused_attention, counter)
    o = fused_attention.fused_qkv_mha(x, *params, lens, 2, prec)
    torch.cuda.synchronize()
    assert getattr(fused_attention, counter) == before + 1
    o32 = fused_attention.fused_qkv_mha(x.float(), *params, lens, 2, prec)
    assert o.dtype == bf and torch.equal(o, o32.to(bf))
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, 2, prec)
    tol = 2.0**-7 * ref.float().abs().max().item() + (5e-3 if prec == "default" else 2e-5)
    assert (o.float() - ref.float()).abs().max().item() <= tol
    for i, n in enumerate(lengths):
        if n == 0:
            assert (o[i] == 0).all()
    x_bad = x.clone()
    for i, n in enumerate(lengths):
        x_bad[i, n:] = float("nan")
    o_bad = fused_attention.fused_qkv_mha(x_bad, *params, lens, 2, prec)
    for i, n in enumerate(lengths):
        assert torch.equal(o_bad[i, :, :n], o[i, :, :n])


def check_highest_bf16_fused(cuda, lengths, t, seed):
    """K4-bf16 ("highest" on a bf16 x: K4's products on the tensor cores,
    three planes of the weights and of Q, K, V and P) on a bf16 x, zero
    past each bound: one launch on its counter (none of K4, K4h, K4b); O
    bf16 within one bf16 step of K4's on the upcast x rounded once beyond
    1e-4 of its max |O| (``assert_near_f32_flavour``); no further from
    ``fused_f64_unrounded`` than 1.5 x the plain version's distance + 1.5
    bf16 steps of its max + 1e-6; a 0-key row O = 0; a rerun the same bits;
    NaN past each bound changes no valid row, 123.0 there leaves every row
    finite. Returns the share of elements that differ from K4's rounded."""
    x, params = _fused_inputs(cuda, len(lengths), t, 2, seed)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = x.to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    names = ("launches_f32_bf16_io", "launches", "launches_high3_bf16_io", "launches_bf16_io")
    before = [getattr(fused_attention, n) for n in names]
    o = fused_attention.fused_qkv_mha(x, *params, lens, 2, "highest")
    torch.cuda.synchronize()
    assert [getattr(fused_attention, n) - c for n, c in zip(names, before)] == [1, 0, 0, 0]
    assert o.shape == (len(lengths), 2, t, 64) and o.dtype == torch.bfloat16
    assert torch.isfinite(o).all()
    o32 = fused_attention.fused_qkv_mha(x.float(), *params, lens, 2, "highest")
    share = assert_near_f32_flavour(o, o32)
    ref = fused_attention.fused_qkv_attention_ref(x, *params, lens, 2, "highest")
    exact = fused_f64_unrounded(x.float(), params, lens, 2)
    err, err_plain = ((a.double() - exact).abs().max().item() for a in (o, ref))
    assert err <= 1.5 * err_plain + 1.5 * BF16_STEP * exact.abs().max().item() + 1e-6
    for i, n in enumerate(lengths):
        if n == 0:
            assert not o[i].any()
    assert torch.equal(fused_attention.fused_qkv_mha(x, *params, lens, 2, "highest"), o)
    for fill, whole in ((float("nan"), False), (123.0, True)):
        dirty = x.clone()
        for i, n in enumerate(lengths):
            dirty[i, n:] = fill
        got = fused_attention.fused_qkv_mha(dirty, *params, lens, 2, "highest")
        assert not whole or torch.isfinite(got).all()
        for i, n in enumerate(lengths):
            assert torch.equal(got[i, :, :n], o[i, :, :n]), (fill, i)
    return share


@pytest.mark.parametrize("t,lengths", [(50, [50, 31, 1, 0]), (511, [511, 499, 64, 0]),
                                       (1024, [1024, 700, 1])])
def test_highest_bf16_fused_within_one_step_of_f32_flavour(cuda, t, lengths):
    """K4-bf16 at the paths' lengths by ``check_highest_bf16_fused``'s
    rules: within one bf16 step of K4 on the upcast x rounded once, near
    float64, a rerun the same bits, garbage past each bound changing no
    valid row."""
    check_highest_bf16_fused(cuda, lengths, t, t + 1)


@pytest.mark.parametrize("t", [1, 50, 63, 64, 65, 127, 128, 129, 511, 512, 1023, 1024])
def test_highest_bf16_fused_cluster_edges(cuda, t):
    """K4-bf16 at every edge of its plan (the 3-block cluster up to 64
    frames, clusters of 2 .. 16 blocks along T, the last chunk ragged) and
    of its 64-key tiles: a full, a ragged, a 1-key and a 0-key row."""
    check_highest_bf16_fused(cuda, [t, max(t // 2, 1), 1, 0], t, 900 + t)


def test_highest_bf16_fused_prologue_splits_the_weights(cuda):
    """K4-bf16's prologue writes the three planes of the packed weights
    bit-equal to ``pack_weights_ref(..., planes=3)``, a bf16 x needs no
    copy, and the call on that workspace gives the wrapper's bits; an f32
    x at "highest" runs K4 (no planes)."""
    x, params = _fused_inputs(cuda, 2, 70, 2, 25)
    x = x.to(torch.bfloat16)
    lens = torch.tensor([70, 33], dtype=torch.int32, device=cuda)
    wp, xr = fused_attention._bf16_workspace(x, 2, planes=3)
    o = fused_attention._launch("highest", x, *params, lens, 2, workspace=(wp, xr))
    torch.cuda.synchronize()
    assert xr is None and wp.shape == (3 * 2 * 192, 128)
    assert torch.equal(wp, fused_attention.pack_weights_ref(*params[0::2], 2, planes=3))
    assert torch.equal(o, fused_attention.fused_qkv_mha(x, *params, lens, 2, "highest"))
    assert fused_attention._planes("highest", False) == 0


def test_highest_bf16_fused_occupancy(cuda):
    """K4-bf16 keeps the 1 block per SM it is built for (222,240 bytes of
    shared memory) at every cluster size of its plan, and each size fits on
    the card; its f32 I/O is K4."""
    for t in [50] + [64 * c for c in range(2, fused_attention.MAX_CLUSTER + 1)]:
        blocks, clusters = fused_attention.fused_occupancy(t, "highest", True)
        assert blocks >= fused_attention.FUSED_HIGHEST_BF16_BLOCKS_PER_SM and clusters >= 1, (
            t, blocks, clusters)
    assert fused_attention.fused_occupancy(511, "highest", False)[0] >= 2


# ---------------- the mesh at world size 1, over NCCL ----------------


@pytest.fixture
def nccl_one(cuda):
    """A one-rank NCCL group and its data mesh."""
    from nomad_tpu_torch.parallel.mesh import data_mesh, destroy_process_group, init_process_group

    init_process_group(0, 1, "cuda")
    try:
        yield data_mesh()
    finally:
        destroy_process_group()


def test_nccl_world_of_one_engine_and_grid(cuda, nccl_one):
    """The mesh engine against the plain one (batch plans may differ:
    1e-5), and the large-scale scorer on a 1 x 1 grid bit-equal to its
    dense path, on a narrow model with 64-wide heads."""
    from nomad_tpu_torch.parallel import grid_mesh
    from nomad_tpu_torch.scoring import EmbeddingEngine, LargeScaleScorer

    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256, num_layers=2)
    model = init_weights(NomadModel(Wav2Vec2Config.base(**kw), emb_dim=16), seed=3)
    model = model.to(cuda).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(7)
    waves = [(0.2 * torch.randn(n, generator=g)).numpy() for n in (9000, 4000, 12000, 7000, 5000)]
    plain = EmbeddingEngine(model, cuda).embed_waves(waves)
    meshed = EmbeddingEngine(model, mesh=nccl_one).embed_waves(waves)
    assert abs(meshed - plain).max() <= 1e-5
    scorer = LargeScaleScorer(EmbeddingEngine(model, cuda))
    avg, dm = scorer.score_embeddings(plain[:3], plain[3:])
    gavg, gdm = LargeScaleScorer.score_on_grid(grid_mesh(1, 1), plain[:3], plain[3:])
    assert (gdm == dm).all() and (gavg == avg).all()


def test_nccl_world_of_one_step_is_bit_equal(cuda, nccl_one):
    """``Training(mesh=)`` at world size 1: one step with dropout (the plain
    dropout attention, K5) gives the plain step's loss, parameters and Adam
    state to the bit (cuDNN's deterministic algorithms in both)."""
    import numpy as np

    from nomad_tpu_torch.training import Training
    from nomad_tpu_torch.training.data import TripletBatch

    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256, num_layers=2)
    sd = init_weights(NomadModel(Wav2Vec2Config.base(**kw), emb_dim=16), seed=4).state_dict()
    rng = np.random.default_rng(8)
    lengths = rng.integers(6000, 8001, size=4).astype(np.int32)
    batch = TripletBatch(*(rng.standard_normal((4, 8000)).astype(np.float32) for _ in range(3)),
                         lengths, lengths, lengths)
    config = {"experiment_name": "none", "lr": 1e-3, "freeze_convnet": True,
              "emb_dim": 16, "masked_pool": True}
    runs = []
    torch.backends.cudnn.deterministic = True  # the positional conv's backward sums in one order
    try:
        for mesh in (None, nccl_one):
            tr = Training(dict(config), device="cuda" if mesh is None else None, mesh=mesh,
                          params=sd, model_config=Wav2Vec2Config.base(**kw))
            tr._build_optimizer()
            loss = tr.train_step(batch, torch.Generator().manual_seed(1))
            runs.append((loss.item(), tr.model.state_dict(), tr.optimizer.state_dict()["state"]))
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(s0[i][k], s1[i][k]) for i in s0 for k in s0[i])


def test_wire_codec_decodes_on_the_card(cuda):
    """The codec's frame decoded on the card: the input's bits, through
    the engine too (packed and raw embeddings bit-equal)."""
    import numpy as np

    from nomad_tpu_torch.ops import wirecodec
    from nomad_tpu_torch.scoring.engine import EmbeddingEngine

    rng = np.random.default_rng(5)
    t = np.arange(2 * 8192) / 16000
    arr = np.round(3000 * np.sin(2 * np.pi * 150 * t)[None] + rng.integers(-40, 40, (6, t.size))
                   ).astype(np.int16)
    arr[2] = rng.integers(-32768, 32768, t.size)
    frame = torch.from_numpy(wirecodec.combined_rows(wirecodec.encode(arr)).view(np.int32))
    dec = wirecodec.decode_combined(frame.to(cuda), *arr.shape)
    assert dec.device.type == "cuda" and np.array_equal(dec.cpu().numpy(), arr)
    tiny64 = Wav2Vec2Config.tiny(hidden_size=128, num_heads=2, ffn_dim=256)  # K1's 64-wide heads
    model = init_weights(NomadModel(tiny64, emb_dim=16), seed=1).to(cuda).eval()
    waves = list(arr[[0, 1, 3, 4, 5]])
    on = EmbeddingEngine(model, cuda, wire_codec="on", parallel_put_min_bytes=1024)
    emb = on.embed_waves(waves)
    assert on.transfer_stats()["codec_hits"] == on.batches >= 1
    assert np.array_equal(emb, EmbeddingEngine(model, cuda).embed_waves(waves))


def test_remat_dots_on_the_card(cuda):
    """``remat_policy="dots"`` with dropout on the kernels: the loss and
    gradients of "full" remat, which recomputes K5 too."""
    wav = torch.randn(3, 4000, generator=torch.Generator().manual_seed(2)).to(cuda)
    lengths = torch.tensor([4000, 3100, 1700], device=cuda)
    out = {}
    for policy in ("full", "dots"):
        model = init_weights(NomadModel(Wav2Vec2Config.tiny(remat=True, remat_policy=policy),
                                        emb_dim=16), seed=4).to(cuda)
        before = layernorm.launches
        emb = model(wav, lengths, deterministic=False,
                    generator=torch.Generator().manual_seed(9))
        loss = (emb[0] - emb[1]).square().sum() + emb[2].sum()
        loss.backward()
        torch.cuda.synchronize()
        out[policy] = (loss.item(), {n: p.grad for n, p in model.named_parameters()
                                     if p.grad is not None}, layernorm.launches - before)
    (loss_f, grads_f, k5_f), (loss_d, grads_d, k5_d) = out["full"], out["dots"]
    assert k5_f == k5_d > 0
    assert abs(loss_d - loss_f) <= 1e-6 * abs(loss_f)
    for name, g in grads_f.items():
        torch.testing.assert_close(grads_d[name], g, rtol=1e-6, atol=1e-7, msg=name)
