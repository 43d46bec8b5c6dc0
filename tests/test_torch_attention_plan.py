"""The launch plans of the port's attention kernels, K1, K1b, K4, K4b and
K4h forward, K2, K3, K2b and K3b backward, held on the CPU: the plan is plain Python
that the C launchers check against their own rules, so what it promises
is what the card runs."""

import pytest
import torch

from nomad_tpu_torch.ops import flash_attention, fused_attention

torch.set_num_threads(2)

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SMEM_PER_SM, SMEM_RESERVED, SMS = 228 * 1024, 1024, 132  # per SM, per block; SMs
# the batch sizes of the paths: single files, the scoring tail and batch,
# the triplet batch and the loss crop
BATCHES = (1, 16, 24, 32, 96)
LENGTHS = sorted({1, 2, 31, 32, 33, 49, 50, 63, 64, 65, 100, 127, 128, 129, 191, 192, 193,
                  255, 256, 257, 499, 511, 512, 513, 700, 767, 768, 769, 1000, 1023, 1024})


@pytest.mark.parametrize("b", BATCHES)
def test_fused_plan_covers_every_row_and_chunk_once(b):
    for t in LENGTHS + list(range(1, 1025, 37)):
        plan = fused_attention.fused_launch_plan(t, b, 12)
        assert 1 <= plan.cluster <= fused_attention.MAX_CLUSTER, t
        assert plan.grid == (plan.cluster, 12, b) and plan.grid[0] % plan.cluster == 0, t
        assert plan.smem_bytes <= SMEM_LIMIT, t
        assert plan.rows_per_block == 64 and plan.tensors_per_block in (1, 3), t
        written = [0] * t
        projected = {g: [0] * t for g in range(3)}
        for rank in range(plan.cluster):
            for start, stop in plan.attends(rank):
                assert 0 <= start < stop <= t and stop - start <= plan.rows_per_block
                for r in range(start, stop):
                    written[r] += 1
            for g, start, stop in plan.projects(rank):
                assert stop - start <= plan.rows_per_block
                for r in range(start, stop):
                    projected[g][r] += 1
        assert written == [1] * t, t
        # each 64-row key chunk of Q, K and V lives in exactly one block
        assert all(projected[g] == [1] * t for g in range(3)), t
        # the loss crop's (32, 50) call fills the card: >= 3 waves at 2
        # blocks per SM on 132 SMs
        if t <= 64:
            assert plan.cluster * 12 * 32 >= 3 * 2 * 132


@pytest.mark.parametrize("t", [0, 1025])
def test_fused_plan_refuses_what_the_kernel_does_not_take(t):
    with pytest.raises(ValueError, match="outside"):
        fused_attention.fused_launch_plan(t, 1, 12)


@pytest.mark.parametrize("b", BATCHES)
def test_fused_bf16_plan_splits_as_k4_and_fits_the_sm(b):
    """K4b's plan (precision "default") splits every (batch, head) as K4's
    does, so the row coverage above holds for it too, and asks for the
    dynamic shared memory and threads the kernel declares: a ring of 3
    stages, each 64 x rows and 192 weight rows of 64 bf16 (32 KB), whose
    memory phase 2's Q, K, V and three key tiles reuse, a "full" and an
    "empty" mbarrier a stage and 1,024 bytes to align the ring; a consumer
    warpgroup and a producer warp. The 2 blocks per SM it is built for fit
    the SM's 228 KB (3 would not); "highest" keeps K4's plan ("high" is
    K4h's, below)."""
    ring = 3 * (64 + 192) * 64 * 2
    phase2 = (3 + 2 * 3) * 64 * 64 * 2  # Q, K, V; three K + V tiles
    assert phase2 <= ring
    for t in LENGTHS + list(range(1, 1025, 37)):
        plan = fused_attention.fused_launch_plan(t, b, 12, "default")
        f32 = fused_attention.fused_launch_plan(t, b, 12)
        assert (plan.cluster, plan.rows_per_block, plan.tensors_per_block, plan.grid) == (
            f32.cluster, f32.rows_per_block, f32.tensors_per_block, f32.grid), t
        assert plan.smem_bytes == fused_attention.FUSED_BF16_SMEM_BYTES == ring + 6 * 8 + 1024
        assert (plan.threads, f32.threads) == (fused_attention.FUSED_BF16_THREADS, 128) == (
            160, 128)
        blocks = fused_attention.FUSED_BF16_BLOCKS_PER_SM
        assert blocks == 2
        assert blocks * (plan.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM < (blocks + 1) * (
            plan.smem_bytes + SMEM_RESERVED)
        assert fused_attention.fused_launch_plan(t, b, 12, "highest") == f32


@pytest.mark.parametrize("b", BATCHES)
def test_fused_high3_plan_splits_as_k4_and_fits_one_block_an_sm(b):
    """K4h's plan (precision "high", K4b's template at three passes)
    splits every (batch, head) as K4's and K4b's do and asks for K4b's
    threads and its own shared memory: every tile in a hi and a lo plane,
    so a ring stage is 64 KB and the ring 192 KB, phase 2's Q, K, V and
    three key tiles (144 KB) in its memory, the 6 mbarriers and the 1,024
    alignment bytes. One block fits an SM, two do not."""
    ring = 2 * 3 * (64 + 192) * 64 * 2
    phase2 = 2 * (3 + 2 * 3) * 64 * 64 * 2
    assert phase2 <= ring
    for t in LENGTHS + list(range(1, 1025, 37)):
        plan = fused_attention.fused_launch_plan(t, b, 12, "high")
        k4b = fused_attention.fused_launch_plan(t, b, 12, "default")
        assert (plan.cluster, plan.rows_per_block, plan.tensors_per_block, plan.grid) == (
            k4b.cluster, k4b.rows_per_block, k4b.tensors_per_block, k4b.grid), t
        assert plan.smem_bytes == fused_attention.FUSED_HIGH3_SMEM_BYTES == (
            ring + 6 * 8 + 1024) == 197_680
        assert plan.smem_bytes <= SMEM_LIMIT and plan.threads == k4b.threads == 160
        blocks = fused_attention.FUSED_HIGH3_BLOCKS_PER_SM
        assert blocks == 1
        assert blocks * (plan.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM < (blocks + 1) * (
            plan.smem_bytes + SMEM_RESERVED)


@pytest.mark.parametrize("t", [0, 1025])
def test_fused_high3_plan_refuses_what_the_kernel_does_not_take(t):
    with pytest.raises(ValueError, match="outside"):
        fused_attention.fused_launch_plan(t, 1, 12, "high")


@pytest.mark.parametrize("t", [0, 1025])
def test_fused_bf16_plan_refuses_what_the_kernel_does_not_take(t):
    with pytest.raises(ValueError, match="outside"):
        fused_attention.fused_launch_plan(t, 1, 12, "default")
    with pytest.raises(ValueError, match="precision"):
        fused_attention.fused_launch_plan(100, 1, 12, "bf16")


@pytest.mark.parametrize("b", BATCHES)
def test_flash_plan_covers_every_query_row(b):
    for t in LENGTHS + [1433, 4095]:
        plan = flash_attention.flash_launch_plan(t, b, 12)
        tiles, h, bb = plan["grid"]
        assert (h, bb) == (12, b) and plan["smem_bytes"] <= SMEM_LIMIT
        assert (tiles - 1) * plan["rows_per_block"] < t <= tiles * plan["rows_per_block"]
        # three blocks of K1 fit the H100's 228 KB of shared memory per SM
        assert 3 * (plan["smem_bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("b", BATCHES)
def test_flash_bwd_plan_covers_every_row_once(b):
    """K2's blocks own the query rows and K3's the key rows: each row of
    every (head, batch) in exactly one block, within the shared memory a
    block may use, and as many blocks per SM as the plan claims fit the
    SM's 228 KB."""
    for t in LENGTHS + [1433, 4095]:
        plans = flash_attention.flash_bwd_launch_plan(t, b, 12)
        assert set(plans) == {"dq", "dkv"}
        for kernel, plan in plans.items():
            tiles, h, bb = plan["grid"]
            rows = plan["rows_per_block"]
            assert (h, bb) == (12, b) and plan["threads"] == 128, (kernel, t)
            owned = [0] * t
            for x in range(tiles):
                for r in range(x * rows, min(t, (x + 1) * rows)):
                    owned[r] += 1
            assert owned == [1] * t, (kernel, t)
            assert (tiles - 1) * rows < t, (kernel, t)  # no block without a row
            assert plan["smem_bytes"] <= SMEM_LIMIT, (kernel, t)
            assert plan["blocks_per_sm"] * (plan["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM


def test_flash_bwd_plan_fills_the_card_at_the_loss_crop():
    """At the loss crop (32 crops, T' = 50, 12 heads) the grid is ~2 waves
    of the card at the blocks per SM the plan claims: 32-row blocks, 3 per
    SM, 768 blocks for 1.94 waves (64-row blocks would give 384 for 0.97).
    16-row blocks would give 2.9 waves but were measured slower (PERF.md):
    they read twice the shared-memory words per FMA."""
    for kernel, plan in flash_attention.flash_bwd_launch_plan(50, 32, 12).items():
        blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
        waves = blocks / (plan["blocks_per_sm"] * SMS)
        assert plan["rows_per_block"] == 32 and waves >= 1.9, (kernel, waves)
    # 64-row blocks beyond T = 64, 3 to an SM
    for kernel, plan in flash_attention.flash_bwd_launch_plan(499, 24, 12).items():
        assert (plan["rows_per_block"], plan["blocks_per_sm"]) == (64, 3), kernel


@pytest.mark.parametrize("b", BATCHES)
def test_flash_bwd_bf16_plan_covers_every_row_once(b):
    """K2b's blocks own 64 query rows and K3b's 64 key rows of the folded
    length (T rounded up to 64, the prologue's fold): each row of every
    (head, batch) in exactly one block, and no block wholly in the
    padding; a consumer warpgroup and a producer warp; the dynamic shared
    memory the kernels declare (two resident 64-row bf16 tiles, a ring of
    3 stages of two, K3b's LSE and Di a stage, the barriers, 1,024 bytes of
    alignment) times the blocks per SM each is built for (K2b 3, K3b 2)
    within an SM."""
    tile = 64 * 64 * 2
    for t in LENGTHS + [1433, 4095]:
        plans = flash_attention.flash_bwd_bf16_launch_plan(t, b, 12)
        assert {k: p["blocks_per_sm"] for k, p in plans.items()} == {"dq": 3, "dkv": 2}
        for kernel, plan in plans.items():
            tiles, h, bb = plan["grid"]
            assert (h, bb, plan["threads"], plan["rows_per_block"]) == (12, b, 160, 64)
            assert plan["stages"] == 3 and plan["t_pad"] == tiles * 64
            assert plan["smem_bytes"] == 2 * tile + 3 * 2 * tile + 3 * 2 * 64 * 4 + 7 * 8 + 1024
            owned = [0] * t
            for blk in range(tiles):
                for r in range(blk * 64, min(blk * 64 + 64, t)):
                    owned[r] += 1
            assert owned == [1] * t, (kernel, t)
            assert (tiles - 1) * 64 < t <= tiles * 64, (kernel, t)  # no block in the padding
            assert plan["smem_bytes"] <= SMEM_LIMIT
            assert plan["blocks_per_sm"] * (plan["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("b", BATCHES)
def test_flash_bf16_plan_covers_every_row_once(b):
    """K1b's blocks own 64 query rows of the folded length (T rounded up to
    64, its prologue's fold): each row of every (head, batch) in exactly one
    block, and no block wholly in the padding; a consumer warpgroup and a
    producer warp; a ring of at least 3 stages; the dynamic shared memory
    the kernel declares (the Q tile, each stage's K and V tiles, a "full"
    and an "empty" barrier a stage, 1,024 bytes of alignment) times the
    blocks per SM it is built for within an SM."""
    tile = 64 * 64 * 2
    for t in LENGTHS + [1433, 4095]:
        plan = flash_attention.flash_bf16_launch_plan(t, b, 12)
        tiles, h, bb = plan["grid"]
        assert (h, bb, plan["threads"], plan["rows_per_block"]) == (12, b, 160, 64), t
        assert plan["stages"] >= 3 and plan["t_pad"] == tiles * 64, t
        assert plan["smem_bytes"] == tile + plan["stages"] * 2 * tile + plan["stages"] * 2 * 8 \
            + 1024
        owned = [0] * t
        for blk in range(tiles):
            for r in range(blk * 64, min(blk * 64 + 64, t)):
                owned[r] += 1
        assert owned == [1] * t, t
        assert (tiles - 1) * 64 < t <= tiles * 64, t  # no block in the padding
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
