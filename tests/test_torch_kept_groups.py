"""chip_smoke's grouped check of kept K1 inputs, on the CPU: plain_grouped
(several grids of one config in one plain run, rows stacked and each
grid's T padded with NOP columns) gives every grid exactly what its own
plain run gives, and check_queued_inputs holds each queued grid's kernel
result against it, fails on a difference, and empties the queue."""

import numpy as np
import pytest
import torch

import chip_smoke
from gome_tpu_torch.engine import BookConfig
from gome_tpu_torch.ops import match_step

# (case, rows, T): grids of one config with ragged widths and depths.
GRIDS = (("deep", 3, 24), ("full", 2, 7), ("wipe", 4, 16), ("deep", 1, 40),
         ("dup_oids", 5, 3), ("heavy", 2, 19))


def _grids(config, seed):
    rng = np.random.default_rng(seed)
    return [chip_smoke.edge_case(rng, config, name, s, t, "cpu")
            for name, s, t in GRIDS]


def _equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("cap,k,dtype", [(16, 4, "int32"), (32, 8, "int64")])
def test_plain_grouped_equals_each_grid_alone(cap, k, dtype):
    config = BookConfig(cap=cap, max_fills=k, dtype=dtype)
    grids = _grids(config, seed=cap)
    grouped = chip_smoke.plain_grouped(config, grids)
    assert len(grouped) == len(grids)
    for (books, ops), (gb, gout) in zip(grids, grouped):
        pb, pout = match_step.batch_step_reference(config, books, ops)
        _equal(gb, pb)
        _equal(gout, pout)


def _queue(monkeypatch, config, grids, labels):
    queue = [(label, [(config, b, o) for b, o in part])
             for label, part in zip(labels, grids)]
    monkeypatch.setattr(chip_smoke, "KEPT_QUEUE", queue)
    monkeypatch.setattr(chip_smoke, "GROUP_CELLS", 128)
    return queue


def test_check_queued_inputs_prints_each_call_and_empties(monkeypatch,
                                                          capsys):
    config = BookConfig(cap=16, max_fills=4, dtype="int32")
    grids = _grids(config, seed=5)
    _queue(monkeypatch, config, [grids[:2], grids[2:]], ["call a", "call b"])
    worst, secs = chip_smoke.check_queued_inputs("test group")
    out = capsys.readouterr().out
    assert worst == 0 and secs >= 0
    assert chip_smoke.KEPT_QUEUE == []
    assert out.count("kernel equal to its plain version") == 2
    assert "call a:" in out and "call b:" in out
    assert "6 K1 grids kept by 2 calls" in out


def test_check_queued_inputs_fails_on_a_wrong_kernel(monkeypatch):
    config = BookConfig(cap=16, max_fills=4, dtype="int32")
    grids = _grids(config, seed=6)
    _queue(monkeypatch, config, [grids[:3], grids[3:]], ["good", "bad"])
    real = match_step.batch_step

    def wrong(cfg, books, ops):
        nb, out = real(cfg, books, ops)
        if ops.action.shape == grids[4][1].action.shape:
            nb = nb._replace(lots=nb.lots + 1)
        return nb, out

    monkeypatch.setattr(match_step, "batch_step", wrong)
    with pytest.raises(SystemExit, match="bad: kernel differs"):
        chip_smoke.check_queued_inputs("test group")


def test_check_kept_inputs_checks_cpu_grids_at_once(monkeypatch):
    """With the queue set, grids on the CPU are still checked at once and
    nothing is queued (only card grids wait for the grouped check)."""
    config = BookConfig(cap=16, max_fills=4, dtype="int32")
    books, ops = _grids(config, seed=7)[0]
    monkeypatch.setattr(chip_smoke, "KEPT_QUEUE", [])
    kept = {"batch_step": {"deep": (1, (config, books, ops))},
            "hawkes_scan": {}}
    worst, line = chip_smoke.check_kept_inputs("cpu call", kept)
    assert worst == 0 and chip_smoke.KEPT_QUEUE == []
    assert line.startswith("cpu call: kernel equal to its plain version")
