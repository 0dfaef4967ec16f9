"""Helpers that carry inputs and outputs between gome_tpu (JAX) and its
PyTorch port, plus the parity of the port's copied host modules (types,
fixed, oracle, streams). Everything crosses as numpy arrays or plain
Python values; the port runs on the CPU (device="cpu")."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gome_tpu.fixed as jfixed
import gome_tpu.types as jtypes
import gome_tpu_torch.fixed as tfixed
import gome_tpu_torch.types as ttypes
from gome_tpu.oracle import OracleEngine as JOracle
from gome_tpu.utils import streams as jstreams
from gome_tpu_torch.engine.book import BookState, DeviceOp
from gome_tpu_torch.oracle import OracleEngine as TOracle
from gome_tpu_torch.utils import streams as tstreams

DTYPES = ("int32", "int64")


def jnp_dtype(name):
    return jnp.dtype(name)


def torch_dtype(name):
    return {"int32": torch.int32, "int64": torch.int64}[name]


# -- host branches ------------------------------------------------------------

HOSTS = ("native", "python")


def use_host(monkeypatch, host):
    """Select the port's host branches before an engine is built: "native"
    (its C++ interner, pre-pool, grid pack and compact decode; g++ is
    required here) or "python" (the branches that run without g++), by
    patching the port's nativehost.available for the test."""
    from gome_tpu_torch.engine import nativehost

    if host == "python":
        monkeypatch.setattr(nativehost, "available", lambda: False)
    else:
        assert nativehost.available()


def assert_host(engine, host):
    """A port MatchEngine runs the selected branches."""
    names = (type(engine.pre_pool).__name__,
             type(engine.batch.oids).__name__)
    assert names == ({"native": ("NativePrePool", "NativeInterner"),
                      "python": ("LocalPrePool", "Interner")}[host])


# -- orders and events --------------------------------------------------------

def _order(types, o):
    return types.Order(
        uuid=o.uuid, oid=o.oid, symbol=o.symbol, side=types.Side(int(o.side)),
        price=o.price, volume=o.volume, action=types.Action(int(o.action)),
        order_type=types.OrderType(int(o.order_type)), trace=o.trace,
    )


def to_jax_orders(orders):
    return [_order(jtypes, o) for o in orders]


def to_torch_orders(orders):
    return [_order(ttypes, o) for o in orders]


def _snap(s):
    return (s.uuid, s.oid, s.symbol, int(s.side), s.price, s.volume)


def event_keys(events):
    """MatchResult events of either package as comparable tuples."""
    return [(_snap(e.node), _snap(e.match_node), e.match_volume)
            for e in events]


def oracle_keys(orders):
    """Reference event stream of a JAX-typed order list (every ADD marked
    at submit, as the gateway does)."""
    oracle = JOracle()
    for o in orders:
        oracle.submit(o)
    return event_keys(oracle.drain())


# -- books, grids and outputs --------------------------------------------------

def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def torch_books(books):
    """Any BookState (JAX arrays or numpy) -> the port's BookState on CPU."""
    return BookState(*(torch.from_numpy(np.array(host(a))) for a in books))


def torch_ops(grid: dict):
    """A numpy grid dict -> the port's DeviceOp on CPU."""
    return DeviceOp(**{k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in grid.items()})


def assert_leaves_equal(got, want, check_dtype=True, fields=None):
    """Exact equality of every leaf of two NamedTuples (tolerance 0)."""
    for name in fields or want._fields:
        g, w = host(getattr(got, name)), host(getattr(want, name))
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)
        if check_dtype:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)


def random_grid(rng, s, t, dtype, oid_mod=7, market=0.2, vol_hi=10,
                prices=(90, 111)):
    """[s, t] grid with NOPs, ADDs, DELs and MARKETs; oids repeat
    (``% oid_mod``) so duplicate-oid cancels occur."""
    d = np.dtype(dtype)
    return dict(
        action=rng.integers(0, 3, size=(s, t), dtype=np.int32),
        side=rng.integers(0, 2, size=(s, t), dtype=np.int32),
        is_market=(rng.random((s, t)) < market).astype(np.int32),
        price=rng.integers(*prices, size=(s, t)).astype(d),
        volume=rng.integers(1, vol_hi, size=(s, t)).astype(d),
        oid=(rng.integers(0, 10**6, size=(s, t)) % oid_mod + 1).astype(d),
        uid=rng.integers(1, 4, size=(s, t)).astype(d),
    )


# -- parity of the copied host modules ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_streams_copy_generates_the_same_orders(seed):
    pairs = [
        (jstreams.mixed_stream(n=300, seed=seed, cancel_prob=0.3,
                               market_prob=0.2),
         tstreams.mixed_stream(n=300, seed=seed, cancel_prob=0.3,
                               market_prob=0.2)),
        (jstreams.multi_symbol_stream(n=300, n_symbols=50, seed=seed,
                                      zipf_a=1.2, cancel_prob=0.3),
         tstreams.multi_symbol_stream(n=300, n_symbols=50, seed=seed,
                                      zipf_a=1.2, cancel_prob=0.3)),
        (jstreams.doorder_stream(n=100, seed=seed),
         tstreams.doorder_stream(n=100, seed=seed)),
    ]
    for j, t in pairs:
        assert to_jax_orders(t) == j


def test_oracle_copy_emits_the_same_events():
    orders = tstreams.mixed_stream(n=800, seed=3, cancel_prob=0.3,
                                   market_prob=0.2)
    oracle = TOracle()
    for o in orders:
        oracle.submit(o)
    assert event_keys(oracle.drain()) == oracle_keys(to_jax_orders(orders))


def test_fixed_copy_scales_the_same():
    for v in (0.01, 1.5, 123.45678901, 1e-8):
        assert tfixed.scale(v) == jfixed.scale(v)
        assert tfixed.unscale_external(tfixed.scale(v)) == \
            jfixed.unscale_external(jfixed.scale(v))
    with pytest.raises(ValueError):
        tfixed.scale(1e-9)


def test_order_conversion_round_trips():
    orders = jstreams.mixed_stream(n=200, seed=5, cancel_prob=0.3,
                                   market_prob=0.2)
    assert to_jax_orders(to_torch_orders(orders)) == orders
    assert ttypes.snapshot_of(to_torch_orders(orders)[0]).oid == orders[0].oid
