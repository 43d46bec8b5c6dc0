"""The port's hand-written kernels on the card, against their plain
versions. Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.ops import flash_attention, layernorm

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
    with pytest.raises(NotImplementedError, match="forward-only"):
        layernorm.layer_norm(x.requires_grad_(), w, b)
    q = torch.randn(1, 10, 2, 32, device=cuda)
    lens = torch.tensor([10], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        flash_attention.mha_flash(q, q, q, lens)
    q = torch.randn(1, 10, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="lengths"):
        flash_attention.mha_flash(q, q, q, lens.long())
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention.mha_flash(q.requires_grad_(), q, q, lens)


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
