"""State carried across packages: half a stream runs through one engine,
its export_state() is imported into an engine of the other package, and
both continue on the second half. Events and export_state() must stay
equal — the port's counterpart of carrying weights across."""

import numpy as np
import pytest

from gome_tpu.utils import streams as jstreams
from test_torch_bridge import DTYPES, event_keys, oracle_keys, to_torch_orders
from test_torch_engine import assert_states_equal, engines


def _halves(kind):
    if kind == "mixed":
        orders = jstreams.mixed_stream(n=160, seed=12, cancel_prob=0.3,
                                       market_prob=0.2)
    else:
        orders = jstreams.multi_symbol_stream(n=240, n_symbols=24, seed=13,
                                              zipf_a=1.2, cancel_prob=0.3)
    return orders, orders[: len(orders) // 2], orders[len(orders) // 2:]


def _feed(engine, orders, columnar, port):
    batch = to_torch_orders(orders) if port else orders
    for o in batch:
        engine.mark(o)
    if columnar:
        return event_keys(engine.process_columnar(batch).to_results())
    return event_keys(engine.process(batch))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind, columnar", [("mixed", False), ("zipf", True)])
def test_jax_state_continues_in_the_port(dtype, kind, columnar):
    orders, first, second = _halves(kind)
    j, t = engines(dtype, cap=8, k=2, n_slots=32, max_t=8)
    head = _feed(j, first, columnar, port=False)
    state = j.batch.export_state()
    t.batch.import_state(state)
    assert_states_equal(t.batch.export_state(), state)
    got = _feed(t, second, columnar, port=True)
    want = _feed(j, second, columnar, port=False)
    assert got == want
    assert head + got == oracle_keys(orders)
    assert_states_equal(t.batch.export_state(), j.batch.export_state())


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_state_continues_in_jax(dtype):
    orders, first, second = _halves("zipf")
    j, t = engines(dtype, cap=8, k=2, n_slots=32, max_t=8)
    head = _feed(t, first, True, port=True)
    state = t.batch.export_state()
    j.batch.import_state(state)
    want = _feed(j, second, True, port=False)
    got = _feed(t, second, True, port=True)
    assert got == want
    assert head + got == oracle_keys(orders)
    assert_states_equal(t.batch.export_state(), j.batch.export_state())


def test_exported_books_are_host_copies():
    _, first, _ = _halves("mixed")
    _, t = engines("int32", cap=8, k=2, n_slots=4, max_t=8)
    _feed(t, first, False, port=True)
    state = t.batch.export_state()
    assert all(isinstance(v, np.ndarray) for v in state["books"].values())
    state["books"]["lots"][...] = 0  # mutating the export leaves the engine
    assert int(t.books.lots.sum()) > 0
