"""The operation counts and bounds reproduce hand-worked values."""

import pytest

from benchmark import counts, readers
from benchmark.harness import load_json

W = load_json("configs", "nomad-w2v2-base")["wav2vec2"]


def test_frontend_and_encoder_flops_per_audio_second():
    p = counts.wav2vec2_forward_flops(16000, W, 256)
    # conv 1 (1 -> 512, k 10) over 3,199 frames, then 512 -> 512 at k 3, 3, 3,
    # 3, 2, 2 over 1,599, 799, 399, 199, 99, 49 frames: ~4.9e9
    hand = 2 * 512 * (10 * 3199 + 512 * (3 * (1599 + 799 + 399 + 199) + 2 * (99 + 49)))
    assert p["frontend"] == hand
    assert p["frontend"] == pytest.approx(4.9e9, rel=0.01)
    # 49 frames x 12 blocks x 2 x (4 x 768^2 + 2 x 768 x 3072)
    assert p["blocks"] == 49 * 12 * 2 * (4 * 768 ** 2 + 2 * 768 * 3072)
    assert p["pos_conv"] == 2 * 49 * 768 * 48 * 128
    assert p["attention"] == 12 * 4 * 49 * 49 * 768


def test_loss_step_is_three_forwards_and_a_second_attention():
    p = counts.wav2vec2_forward_flops(160000, W, 256)
    assert counts.frames(160000, W)[-1] == 499
    assert counts.loss_step_flops(160000, W, 256) == pytest.approx(
        3 * sum(p.values()) + p["attention"])


def test_flash_bounds_as_the_smoke_computes_them():
    # [96, 511] full rows: 2 * 2 * 12 * 64 * 511 * (96 * 511) FLOP at 67 TFLOP/s
    ms, by = counts.flash_bound(96, 511, 12, 64, 96 * 511)
    assert by == "operations"
    assert ms == pytest.approx(2 * 2 * 12 * 64 * 511 * 96 * 511 / 67e12 * 1e3)
    b = counts.flash_bwd_bounds(24, 499, 12, 64, 24 * 499, 24)
    pairs = 499 * 24 * 499
    assert b["dq"][0] == pytest.approx(6 * 12 * 64 * pairs / 67e12 * 1e3)
    assert b["dkv"][0] == pytest.approx(8 * 12 * 64 * pairs / 67e12 * 1e3)


def test_waveunet_levels_and_se_step():
    lv = counts.waveunet_levels(16384, 12, 24)
    assert lv[0] == (1, 24, 15, 16384) and lv[11] == (264, 288, 15, 8)
    assert lv[12] == (288, 288, 15, 4)
    assert lv[13] == (288 + 288, 288, 5, 8) and lv[-2] == (48 + 24, 24, 5, 16384)
    assert lv[-1] == (25, 1, 1, 16384)
    unet = sum(2 * a * k * b * t * (2 if i == 0 else 3) for i, (a, b, k, t) in enumerate(lv))
    total = counts.se_step_flops(32, 16384, 12, 24, W, 256)
    assert total == pytest.approx(32 * (unet + counts.loss_step_flops(16384, W, 256)))


def test_k1_needed_time_sums_files_at_their_own_frames():
    class R:
        config = {"wav2vec2": W, "emb_dim": 256}
        state = {}

    per_file = counts.flash_bound(1, 499, 12, 64, 499)[0]
    assert readers.k1_needed_ms(R(), [160000, 160000], 3) == pytest.approx(
        3 * 12 * 2 * per_file)
