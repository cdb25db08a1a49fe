"""The train loop's dropout seed (`train.loop.seed_for_step`) on the CPU,
whose `torch.Generator` keeps only a seed's low 32 bits: two `--rand-seed`
values draw different masks at one step, two steps differ, and data rank 0
draws what a one-process run draws."""

import pytest
import torch

from bist_tpu_torch.models.layers import dropout
from bist_tpu_torch.train.loop import seed_for_step
from torch_threads import two_threads  # noqa: F401 (autouse)


def mask(seed: int, step: int, rank: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed_for_step(seed, step, rank))
    return dropout(torch.ones(4096), 0.5, gen) != 0


def test_a_cpu_generator_keeps_the_low_32_bits():
    """Why the seed is mixed: seeds that differ above bit 31 draw alike."""
    a = torch.rand(4, generator=torch.Generator().manual_seed((1 << 32) + 5))
    b = torch.rand(4, generator=torch.Generator().manual_seed((2 << 32) + 5))
    assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 5, 1000])
def test_two_seeds_draw_different_masks(step):
    assert not torch.equal(mask(1, step), mask(2, step))


@pytest.mark.parametrize("seed", [0, 1, 123456])
def test_two_steps_draw_different_masks(seed):
    assert not torch.equal(mask(seed, 3), mask(seed, 4))


def test_rank_zero_is_a_one_process_run_and_ranks_differ():
    assert seed_for_step(9, 2) == seed_for_step(9, 2, 0)
    assert torch.equal(mask(9, 2), mask(9, 2, 0))
    assert not torch.equal(mask(9, 2, 0), mask(9, 2, 1))


def test_low_32_bits_distinct_over_seeds_steps_and_ranks():
    lows = {seed_for_step(s, k, r) & 0xFFFFFFFF
            for s in range(16) for k in range(16) for r in range(4)}
    assert len(lows) == 16 * 16 * 4
    assert all(0 <= seed_for_step(s, 0) < 1 << 63 for s in (0, 2**40, 2**62))
