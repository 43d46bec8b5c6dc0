"""Dropout in the port's model (training's ``deterministic=False``): the
keep rate and scaling, rate 0 and ``deterministic=True`` as the
deterministic model to the bit, seeded masks, ``remat`` that recomputes
the masks it drew, and the fused path giving way to the plain dropout
attention, as the JAX package's does."""

import numpy as np
import pytest
import torch

from nomad_tpu_torch.models import NomadModel, Wav2Vec2Config, init_weights
from nomad_tpu_torch.models import wav2vec2
from nomad_tpu_torch.ops import dropout, mha_dropout, mha_ref

torch.set_num_threads(2)
EMB = 16
RATES = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def model_for(**cfg) -> NomadModel:
    return init_weights(NomadModel(Wav2Vec2Config.tiny(**cfg), emb_dim=EMB), seed=5)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    wav = torch.from_numpy((0.3 * rng.standard_normal((3, 2000))).astype(np.float32))
    return wav, torch.tensor([2000, 1500, 900])


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_keep_rate_within_a_binomial_bound_and_scaling():
    x = torch.full((200_000,), 2.0)
    p = 0.1
    y = dropout(x, p, gen(1))
    kept = y != 0
    n = x.numel()
    # five standard deviations of a Binomial(n, 1 - p) keep count
    assert abs(kept.sum().item() - n * (1 - p)) < 5 * (n * p * (1 - p)) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / (1 - p)))  # 1/(1 - p)
    assert dropout(x, p, None) is x and dropout(x, 0.0, gen(1)) is x


def test_attention_dropout_is_plain_attention_at_rate_0_and_scales():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 7, 3, 8)).astype(np.float32))
               for _ in range(3))
    mask = torch.tensor([[True] * 7, [True] * 4 + [False] * 3])
    assert torch.equal(mha_dropout(q, k, v, mask, 0.0, gen()), mha_ref(q, k, v, mask))
    # rate p: the same weights, kept ones scaled by 1/(1 - p), on the same mask
    p = 0.25
    weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q / 8 ** 0.5, k)
                            + torch.where(mask, 0.0, -1e9)[:, None, None, :], dim=-1)
    keep = torch.rand(weights.shape, generator=gen(3)) >= p
    want = torch.einsum("bhqk,bkhd->bqhd", torch.where(keep, weights / (1 - p), 0.0), v)
    torch.testing.assert_close(mha_dropout(q, k, v, mask, p, gen(3)), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["forward", "forward_layers", "forward_features"])
def test_rate_0_equals_deterministic_to_the_bit(batch, method):
    wav, lengths = batch
    model = model_for(**ZERO_RATES)
    want = getattr(model, method)(wav, lengths)
    got = getattr(model, method)(wav, lengths, deterministic=False, generator=gen())
    for a, b in zip(want if isinstance(want, list) else [want],
                    got if isinstance(got, list) else [got]):
        assert torch.equal(a, b)


def test_deterministic_ignores_the_rates(batch):
    wav, lengths = batch
    state = model_for(**ZERO_RATES).state_dict()
    with_rates = NomadModel(Wav2Vec2Config.tiny(dropout=0.5, attention_dropout=0.5,
                                                activation_dropout=0.5), emb_dim=EMB)
    with_rates.load_state_dict(state)
    without = model_for(**ZERO_RATES)
    assert torch.equal(with_rates(wav, lengths), without(wav, lengths))


def test_same_seed_same_masks_other_seed_other_masks(batch):
    wav, lengths = batch
    model = model_for(**RATES)
    a = model(wav, lengths, deterministic=False, generator=gen(11))
    b = model(wav, lengths, deterministic=False, generator=gen(11))
    c = model(wav, lengths, deterministic=False, generator=gen(12))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, model(wav, lengths))
    # padded frames stay zero under dropout too
    layers = model.forward_layers(wav, lengths, deterministic=False, generator=gen(11))
    frames = wav2vec2.feature_frame_lengths(lengths, model.config)
    for x in layers[:-1]:
        for i, n in enumerate(frames.tolist()):
            assert not x[i, n:].any()


def _loss_and_grads(model, wav, lengths, seed):
    model.zero_grad(set_to_none=True)
    emb = model(wav, lengths, deterministic=False, generator=gen(seed))
    loss = (emb[0] - emb[1]).square().sum() + emb[2].sum()
    loss.backward()
    return loss.detach(), {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("frontend_stop_gradient", [False, True])
def test_remat_gives_the_same_loss_and_gradients_with_dropout(batch, frontend_stop_gradient):
    """The recompute under torch.utils.checkpoint redraws each block's
    masks from the seed it drew in the forward."""
    wav, lengths = batch
    plain = model_for(frontend_stop_gradient=frontend_stop_gradient, **RATES)
    remat = NomadModel(Wav2Vec2Config.tiny(remat=True,
                                           frontend_stop_gradient=frontend_stop_gradient,
                                           **RATES), emb_dim=EMB)
    remat.load_state_dict(plain.state_dict())
    loss, grads = _loss_and_grads(plain, wav, lengths, 21)
    loss_r, grads_r = _loss_and_grads(remat, wav, lengths, 21)
    assert torch.equal(loss, loss_r)
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=1e-6, atol=1e-9, msg=name)
    frontend = [n for n in grads if "feature_encoder" in n]
    assert all(bool(grads[n].abs().max() == 0) == frontend_stop_gradient for n in frontend)


@pytest.mark.parametrize("islands", ["exact", "fast"])
def test_remat_dots_gives_the_same_loss_and_gradients(batch, islands, monkeypatch):
    """``remat_policy="dots"`` with dropout: the loss and gradients of the
    model without remat, to the bit here, and the policy keeps every
    product of each block (6 linear layers and the attention's 2 products),
    those inside ``ops/precision.py``'s autograd Functions at a bf16
    island included, and nothing else."""
    cfg = {**RATES, **wav2vec2.PRECISION_ISLANDS[islands]}
    plain = init_weights(NomadModel(Wav2Vec2Config.tiny(**cfg), emb_dim=EMB), seed=5)
    dots = NomadModel(Wav2Vec2Config.tiny(remat=True, remat_policy="dots", **cfg), emb_dim=EMB)
    dots.load_state_dict(plain.state_dict())
    saved = []
    policy = wav2vec2._dots_saveable

    def spy(ctx, op, *args, **kwargs):
        verdict = policy(ctx, op, *args, **kwargs)
        if verdict == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op.overloadpacket)
        return verdict

    monkeypatch.setattr(wav2vec2, "_dots_saveable", spy)
    wav, lengths = batch
    loss, grads = _loss_and_grads(plain, wav, lengths, 21)
    assert not saved
    loss_d, grads_d = _loss_and_grads(dots, wav, lengths, 21)
    assert torch.equal(loss, loss_d)
    for name, g in grads.items():
        torch.testing.assert_close(grads_d[name], g, rtol=1e-6, atol=1e-9, msg=name)
    layers = dots.config.num_layers
    linear = torch.ops.aten.mm if islands == "fast" else torch.ops.aten.addmm
    assert saved.count(linear) == 6 * layers and saved.count(torch.ops.aten.bmm) == 2 * layers
    assert len(saved) == 8 * layers


def test_remat_policy_dots_is_not_ported():
    """The remat policies' checks. "dots", once refused, now builds (the
    selective checkpoint: ``test_remat_dots_gives_the_same_loss_and_gradients``);
    an unknown policy and a rate of 1 raise."""
    assert Wav2Vec2Config.tiny(remat=True, remat_policy="dots").remat_policy == "dots"
    with pytest.raises(ValueError, match="remat_policy"):
        Wav2Vec2Config.tiny(remat_policy="some")
    with pytest.raises(ValueError, match="dropout"):
        Wav2Vec2Config.tiny(dropout=1.0)


def test_fused_qkv_gives_way_to_the_plain_dropout_path(batch, monkeypatch):
    wav, lengths = batch
    kernel = model_for(**RATES)
    fused = NomadModel(Wav2Vec2Config.tiny(attention_impl="fused_qkv", **RATES), emb_dim=EMB)
    fused.load_state_dict(kernel.state_dict())
    det = fused(wav, lengths)  # deterministic: the fused path (K4's plain version here)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused attention ran under attention dropout")

    monkeypatch.setattr(wav2vec2, "fused_qkv_attention", refuse)
    got = fused(wav, lengths, deterministic=False, generator=gen(4))
    assert torch.equal(got, kernel(wav, lengths, deterministic=False, generator=gen(4)))
    with pytest.raises(AssertionError, match="fused attention ran"):
        fused(wav, lengths)
    torch.testing.assert_close(det, kernel(wav, lengths), rtol=1e-5, atol=1e-6)
