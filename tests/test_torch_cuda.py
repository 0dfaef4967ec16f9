"""Tests that need the CUDA card: the match-step kernel against its plain
PyTorch version, and the engine on the card against the oracle. They skip
where torch.cuda.is_available() is False. This file imports no JAX, so on
a machine with the card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.ops import match_step
from gome_tpu_torch.utils.streams import mixed_stream, multi_symbol_stream

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "cap, k, dtype, fill",
    [
        (16, 4, torch.int32, 0.9),
        (256, 16, torch.int32, 0.6),
        (256, 16, torch.int64, 0.6),
        (64, 64, torch.int64, 0.9),
        (4096, 16, torch.int32, 0.9),
        (8192, 16, torch.int64, 0.9),
    ],
)
def test_kernel_matches_plain_version(cuda, cap, k, dtype, fill):
    rng = np.random.default_rng(cap + k)
    config = BookConfig(cap=cap, max_fills=k, dtype=dtype)
    books, seeded = chip_smoke.deep_books(rng, config, 24, fill, cuda)
    grids = chip_smoke.flow_grids(rng, config, 24, 16, 3, seeded, cuda)
    before = [a.clone() for a in books]
    assert chip_smoke.check_kernel_case(f"cap {cap}", config, books, grids) == 0
    for a, b in zip(books, before):
        assert torch.equal(a, b)  # the kernel never writes its inputs


# (case, rows, T, cap, K, dtype): inputs aimed at the kernel's shortcuts
# (chip_smoke.edge_case), at widths the engine reaches on the card.
EDGE_CASES = [
    ("deep", 1, 512, 2048, 16, torch.int32),
    ("deep", 4, 256, 256, 16, torch.int64),
    ("full", 24, 64, 256, 16, torch.int32),
    ("full", 8, 64, 2048, 16, torch.int32),
    ("full", 8, 64, 64, 64, torch.int64),
    ("wipe", 24, 64, 256, 16, torch.int32),
    ("wipe", 4, 32, 4096, 16, torch.int64),
    ("del_ends", 16, 128, 256, 16, torch.int32),
    ("del_ends", 4, 96, 2048, 16, torch.int64),
    ("dup_oids", 24, 64, 256, 16, torch.int64),
    ("heavy", 24, 64, 256, 16, torch.int32),
    ("heavy", 8, 64, 2048, 16, torch.int32),
    ("stale_tails", 24, 64, 256, 16, torch.int32),
    ("full", 4, 64, 8192, 16, torch.int64),
]


@pytest.mark.parametrize("name, s, t, cap, k, dtype", EDGE_CASES)
def test_kernel_matches_plain_version_on_edge_cases(cuda, name, s, t, cap, k,
                                                    dtype):
    rng = np.random.default_rng(cap * 1000 + t + s)
    config = BookConfig(cap=cap, max_fills=k, dtype=dtype)
    books, grid = chip_smoke.edge_case(rng, config, name, s, t, cuda)
    before = [a.clone() for a in (*books, *grid)]
    assert chip_smoke.check_kernel_case(name, config, books, [grid]) == 0
    for a, b in zip((*books, *grid), before):
        assert torch.equal(a, b)


def test_engine_on_the_card_matches_the_oracle(cuda):
    config = BookConfig(cap=16, max_fills=4, dtype=torch.int32)
    zipf = multi_symbol_stream(n=3000, n_symbols=200, zipf_a=1.2,
                               cancel_prob=0.3, seed=3)
    hot = mixed_stream(n=1500, cancel_prob=0.3, market_prob=0.2, seed=4)
    e1 = MatchEngine(config, n_slots=256, max_t=16)
    e2 = MatchEngine(config, n_slots=4, max_t=16)
    match_step.batch_step.launches = 0
    got1, _ = chip_smoke.run_engine(e1, zipf, 700, columnar=True)
    got2, _ = chip_smoke.run_engine(e2, hot, 500, columnar=False)
    assert got1 == chip_smoke.oracle_events(zipf)
    assert got2 == chip_smoke.oracle_events(hot)
    e1.batch.verify_books()
    e2.batch.verify_books()
    calls = e1.stats.device_calls + e2.stats.device_calls
    assert match_step.batch_step.launches == calls > 0
    assert e2.stats.cap_escalations and e2.stats.fill_record_escalations
