"""The port's fleet routing tier (gome_tpu_torch/fleet/router.py) against
gome_tpu's: the same partition for every symbol, and the same
PartitionMap / HealthGate / PartitionRouter / FailoverController
transitions over one scripted sequence. Exact equality."""

import threading

import numpy as np
import pytest

from gome_tpu.fleet import router as jrouter
from gome_tpu_torch.fleet import router as trouter

SIDES = (jrouter, trouter)


def symbols(n: int, seed: int = 3) -> list[str]:
    rng = np.random.default_rng(seed)
    out = [f"sym{i}" for i in range(n // 2)]
    # Random byte strings as well, multi-byte UTF-8 included.
    for _ in range(n - len(out)):
        cps = rng.integers(0x21, 0x2FF, size=int(rng.integers(1, 12)))
        out.append("".join(chr(int(c)) for c in cps))
    return out


@pytest.mark.parametrize("p", [1, 2, 3, 8, 64])
def test_partition_of_matches(p):
    syms = symbols(10_000)
    got = [trouter.partition_of(s, p) for s in syms]
    assert got == [jrouter.partition_of(s, p) for s in syms]
    assert set(got) <= set(range(p))
    if p > 1:
        assert len(set(got)) == p


def test_partition_of_rejects_like_the_reference():
    for mod in SIDES:
        with pytest.raises(ValueError, match="n_partitions must be positive"):
            mod.partition_of("x", 0)


def script(mod) -> list:
    """One scripted run of every transition: bootstrap, routing, debounced
    health, a failover race (lost claim, failed recovery, committed
    handoff), a rebalance that voids a stale claim, and the errors."""
    log = []
    pmap = mod.PartitionMap.even(8, ["m0", "m1", "m2"])
    gate = mod.HealthGate(suspect_after=2, down_after=3)
    router = mod.PartitionRouter(pmap, gate)
    ctl = mod.FailoverController(pmap, gate, lock=threading.Lock())
    log.append(("snapshot", pmap.snapshot(), pmap.members()))
    syms = [f"sym{i}" for i in range(40)]
    log.append(("route", [router.route(s) for s in syms],
                [router.partition(s) for s in syms]))
    for healthy in (False, True, False, False, False, False):
        log.append(("health", gate.record("m1", healthy)))
    log.append(("gate", gate.snapshot(), gate.is_down("m1"), gate.state("zz")))
    try:
        for s in syms:
            router.route(s)
    except mod.RouteUnavailable as e:
        log.append(("unavailable", e.symbol, e.partition, e.member, str(e)))
    log.append(("claim up", ctl.claim("m0", "s1")))
    c = ctl.claim("m1", "s1")
    log.append(("claim", c.standby, c.epoch, c.state, c.partitions))
    log.append(("second claim", ctl.claim("m1", "s2")))
    ctl.release("m1", "s2")  # not the holder: no effect
    log.append(("commit other", ctl.commit("m1", "s2")))
    ctl.release("m1", "s1")

    def boom(dead, parts):
        raise RuntimeError(f"restore of {dead} {parts} failed")

    with pytest.raises(RuntimeError, match="restore of m1"):
        ctl.failover("m1", "s2", boom)
    seen = []
    epoch = ctl.failover("m1", "s3", lambda d, ps: seen.append((d, ps)))
    log.append(("failover", epoch, seen, pmap.snapshot(), ctl.history()))
    log.append(("route after", [router.route(s) for s in syms]))
    gate.mark_down("m2")
    c = ctl.claim("m2", "s4")
    pmap.reassign([0], "m0")  # a rebalance under the claim
    log.append(("stale commit", c.epoch, ctl.commit("m2", "s4"),
                pmap.epoch, pmap.partitions_of("m2")))
    log.append(("nothing left", ctl.claim("m1", "s5")))
    for bad in (lambda: mod.PartitionMap(2, {0: "a"}),
                lambda: mod.PartitionMap(2, {0: "a", 1: "b", 2: "c"}),
                lambda: mod.PartitionMap(1, {0: ""}),
                lambda: mod.PartitionMap.even(2, []),
                lambda: mod.HealthGate(3, 2),
                lambda: pmap.reassign([99], "m0"),
                lambda: pmap.reassign([0], "")):
        try:
            bad()
        except (ValueError, KeyError) as e:
            log.append(("error", type(e).__name__, str(e)))
    return log


def test_scripted_transitions_match():
    got, want = script(trouter), script(jrouter)
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        assert g == w
