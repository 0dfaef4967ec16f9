"""chip_smoke's fuzz drill (phase 16 (a)) against scripts/fuzz.py on the
CPU: for seeds 0-7 the port's case is the reference's (the same geometry,
mode, orders and chunking from the same np.random.default_rng draws: equal
case lines, event and escalation counts included, run_case's own engine
against its oracle passing), and its events equal the port's oracle's (in
the case) and gome_tpu's oracle's; two sim cases take the reference's
jax.random flow for the seed and give run_sim_case's line, and two run the
port's own simulator flow. Exact equality throughout."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

import chip_smoke
from gome_tpu import types as jtypes
from gome_tpu.oracle import OracleEngine as JOracle
from gome_tpu_torch import types as ttypes

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "gome_fuzz_ref", os.path.join(_ROOT, "scripts", "fuzz.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)


def as_tuples(events):
    return [tuple(int(x) if isinstance(x, int) else x
                  for x in dataclasses.astuple(e)) for e in events]


def to_reference(order):
    """A port Order as gome_tpu's (the same fields)."""
    kw = {f.name: getattr(order, f.name)
          for f in dataclasses.fields(ttypes.Order)}
    kw["side"] = jtypes.Side(int(kw["side"]))
    kw["action"] = jtypes.Action(int(kw["action"]))
    kw["order_type"] = jtypes.OrderType(int(kw["order_type"]))
    return jtypes.Order(**kw)


def to_port(order):
    kw = {f.name: getattr(order, f.name)
          for f in dataclasses.fields(jtypes.Order)}
    kw["side"] = ttypes.Side(int(kw["side"]))
    kw["action"] = ttypes.Action(int(kw["action"]))
    kw["order_type"] = ttypes.OrderType(int(kw["order_type"]))
    return ttypes.Order(**kw)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_case_is_the_references(seed):
    """The port's case line equals run_case's for the seed (the case
    description, the event count and both escalation counts), and its
    events equal gome_tpu's oracle over the same orders."""
    got = chip_smoke.fuzz_case(seed, device="cpu")
    assert got["line"] == ref.run_case(seed)
    oracle = JOracle()
    want = []
    for o in got["orders"]:
        want.extend(oracle.process(to_reference(o)))
    assert as_tuples(got["events"]) == as_tuples(want)
    assert got["launches"] == 0  # the CPU runs K1's plain version


def test_fuzz_cases_cover_every_mode_and_dtype():
    """The drill's seeds on the CPU at a small count: the counts by mode
    and dtype add up, and seeds 0-7 reach all three paths and both
    dtypes."""
    f = chip_smoke.fuzz_drill("cpu", n=8, seed0=0, n_sim=0)
    assert f["cases"] == sum(f["by"].values()) == 8
    assert {m for m, _ in f["by"]} == {"object", "columnar", "frame"}
    assert {d for _, d in f["by"]} == {"int32", "int64"}
    assert f["record_escalations"] > 0 and f["cap_escalations"] > 0
    assert "0 divergences" in chip_smoke.fuzz_text(f)


def reference_sim_orders(seed):
    """run_sim_case's flow for the seed: the same rng draws for the flow
    config, gome_tpu's env on jax.random.PRNGKey(seed)."""
    import jax
    import jax.numpy as jnp

    from gome_tpu.engine import BookConfig
    from gome_tpu.sim.env import EnvConfig, env_reset
    from gome_tpu.sim.flow import FlowConfig
    from gome_tpu.sim.replay import _record_step, orders_from_grid

    rng = np.random.default_rng(seed)
    flow = FlowConfig(
        n_lanes=int(rng.choice([2, 4, 7])),
        t_bins=int(rng.choice([32, 64])),
        excite_self=float(rng.choice([0.25, 0.45])),
        cancel_rate=float(rng.choice([0.8, 1.4, 2.0])),
        market_rate=float(rng.choice([0.2, 0.8])),
        offset_p=float(rng.choice([0.2, 0.5])),
        vol_max=int(rng.choice([5, 60])),
    )
    gen_cfg = EnvConfig(
        flow=flow, book=BookConfig(cap=64, max_fills=8, dtype=jnp.int32))
    n_grids = int(rng.choice([8, 20]))
    state, _ = env_reset(gen_cfg, jax.random.PRNGKey(seed))
    orders = []
    for _ in range(n_grids):
        state, bg_ops, _info = _record_step(gen_cfg, state)
        orders.extend(orders_from_grid(jax.device_get(bg_ops)._asdict()))
    return orders


@pytest.mark.parametrize("seed", [7000, 7001])
def test_fuzz_sim_case_on_the_references_flow(seed):
    """Given run_sim_case's own flow, the port's sim case draws the same
    adversarial geometry and gives run_sim_case's line; its events equal
    gome_tpu's oracle's."""
    orders = reference_sim_orders(seed)
    got = chip_smoke.fuzz_sim_case(seed, device="cpu",
                                   orders=[to_port(o) for o in orders])
    assert got["line"] == ref.run_sim_case(seed)
    oracle = JOracle()
    want = []
    for o in orders:
        want.extend(oracle.process(o))
    assert as_tuples(got["events"]) == as_tuples(want)


@pytest.mark.parametrize("seed", [7002, 7003])
def test_fuzz_sim_case_on_the_ports_flow(seed):
    """The port's simulator makes the flow (torch's generator, so other
    orders than jax.random's); the geometry and the line's shape are the
    reference's, the events the port's oracle's (checked in the case) and
    gome_tpu's."""
    got = chip_smoke.fuzz_sim_case(seed, device="cpu")
    want_line = ref.run_sim_case(seed)
    mask = lambda line: [w for w in line.split()  # noqa: E731
                         if not w.startswith(("n=", "events=", "esc="))]
    assert mask(got["line"]) == mask(want_line)
    assert got["orders"] and got["events"]
    oracle = JOracle()
    want = []
    for o in got["orders"]:
        want.extend(oracle.process(to_reference(o)))
    assert as_tuples(got["events"]) == as_tuples(want)
