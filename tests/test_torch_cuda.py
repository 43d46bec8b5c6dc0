"""The port's hand-written kernels on the card, against their plain
versions. Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from nomad_tpu_torch.api import Nomad
from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.ops import flash_attention, fused_attention, layernorm

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
    """The narrow model on the fused path: K4 once per block and no K1,
    embeddings against the plain path and batch-1 against the padded
    batch."""
    kw = dict(hidden_size=128, num_heads=2, ffn_dim=256)
    model = init_weights(NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv", **kw),
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
