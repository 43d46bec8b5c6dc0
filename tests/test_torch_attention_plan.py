"""The launch plans of the port's attention kernels, K1 and K4 forward,
K2 and K3 backward, held on the CPU: the plan is plain Python that the C
launchers check against their own rules, so what it promises is what the
card runs."""

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
