"""The plain references agree with the port's plain path at a tiny size on
the CPU: wav2vec 2.0 embeddings and block outputs, the NOMAD loss and its
gradient, the Wave-U-Net's training forward with its running statistics,
and Adam."""

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import wav, wav2vec2 as ref_w2v, waveunet as ref_unet
from benchmark.tests import tiny
from benchmark.traffic import audio


def _nomad(sd):
    from nomad_tpu_torch.api import Nomad
    from nomad_tpu_torch.models import Wav2Vec2Config

    w = tiny.W2V
    cfg = Wav2Vec2Config.tiny(attention_impl="ref", layernorm_impl="ref")
    assert list(cfg.conv_dim) == w["conv_dim"] and cfg.hidden_size == w["hidden_size"]
    return Nomad(device="cpu", config=cfg, emb_dim=16, params=sd)


def _weights(seed=3):
    return weights.seeded(ref_w2v.param_shapes(tiny.W2V, 16), seed, "cpu")


def test_embeddings_and_loss_match_the_port():
    sd = _weights()
    nomad = _nomad(sd)
    g = torch.Generator().manual_seed(0)
    clean = 0.1 * torch.randn(3, 6000, generator=g)
    est = clean + 0.05 * torch.randn(3, 6000, generator=g)
    with torch.no_grad():
        got = nomad.model(clean)
        want = ref_w2v.embed(sd, tiny.W2V, clean)
    assert torch.allclose(got, want, atol=2e-6), (got - want).abs().max()
    x = est.clone().requires_grad_(True)
    loss = nomad.forward(x, clean)
    loss.backward()
    ref_loss, ref_grad = ref_w2v.loss_and_grad(sd, tiny.W2V, est, clean, rows=2)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-6 * abs(ref_loss)
    assert float((x.grad - ref_grad).norm() / ref_grad.norm()) < 1e-5


def test_frame_count_matches_the_port():
    from nomad_tpu_torch.models import Wav2Vec2Config, feature_frame_lengths

    base = Wav2Vec2Config.base()
    w = {"conv_kernel": list(base.conv_kernel), "conv_stride": list(base.conv_stride)}
    for n in (16384, 160000, 24_000, 383_999):
        assert ref_w2v.frame_count(n, w) == int(feature_frame_lengths(n, base))
    assert ref_w2v.frame_count(160000, w) == 499


def test_waveunet_step_matches_the_port():
    from nomad_tpu_torch.models import WaveUNet

    shapes = ref_unet.param_shapes(3, 4)
    sd = weights.seeded(shapes, 5, "cpu", stream=1)
    net = WaveUNet(3, 4)
    net.load_state_dict(sd, strict=True)
    net.train()
    x = 0.1 * torch.randn(2, 1024, generator=torch.Generator().manual_seed(1))
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()
              if not shapes[k][1].startswith("stat")}
    stats = {k: v.clone() for k, v in sd.items() if shapes[k][1].startswith("stat")}
    want = ref_unet.forward_train(params, stats, 3, x)
    got = net(x)
    # the upsampling differs by an ulp (torch's interpolate against the
    # port's gather-and-blend), which the batch norm's E[x^2] - E[x]^2
    # amplifies in its small-variance channels: 6.4e-5 here
    assert torch.allclose(got, want, atol=2e-4)
    for k, v in stats.items():
        assert torch.allclose(net.state_dict()[k], v, atol=1e-6), k
    # Adam: three steps of the written-out update against torch.optim.Adam
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    mine = {k: v.detach().clone() for k, v in params.items()}
    adam = ref_unet.Adam(mine, 1e-3)
    for _ in range(3):
        opt.zero_grad()
        loss = (net(x) ** 2).mean()
        loss.backward()
        opt.step()
        grads = dict(zip(params, torch.autograd.grad(
            (ref_unet.forward_train({k: v.requires_grad_(True) for k, v in mine.items()},
                                    dict(stats), 3, x) ** 2).mean(), list(mine.values()))))
        for v in mine.values():
            v.requires_grad_(False)
        adam.step(mine, grads)
    named = dict(net.named_parameters())
    for k, v in mine.items():
        if k.endswith(".conv.bias"):
            continue  # ahead of a batch norm: a gradient of rounding, Adam's sign of it
        assert torch.allclose(named[k].detach(), v, atol=1e-5), k


def test_wav_reader_reads_what_the_generator_writes(tmp_path):
    x = audio.pcm16(audio.speech_like(np.random.default_rng(0), 5000, 0.01))
    audio.write_pcm16(str(tmp_path / "a.wav"), x)
    got, sr = wav.read_pcm16(str(tmp_path / "a.wav"))
    assert sr == 16000 and np.array_equal(got, x.astype(np.float32) / 32768.0)
    from nomad_tpu_torch.io import read_wav

    port, port_sr = read_wav(str(tmp_path / "a.wav"))
    assert port_sr == 16000 and np.array_equal(port[0], got)
