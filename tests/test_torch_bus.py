"""The port's bus (gome_tpu_torch.bus: memory, file and native file queues, the JSON
codecs, the batch order decode, the columnar ORDER and EVENT frames) on
the CPU against gome_tpu.bus: the same operations on both packages give
the same offsets, bodies, errors and bytes, and each package decodes the
other's frames. Exact equality, tolerance 0."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

import gome_tpu.bus as jbus
import gome_tpu.bus.native as jnative
import gome_tpu.types as jtypes
import gome_tpu_torch.bus as tbus
import gome_tpu_torch.types as ttypes
from gome_tpu.bus import colwire as jcw
from gome_tpu.engine import frames as jframes
from gome_tpu.utils import faults as jfaults
from gome_tpu.utils.metrics import Registry as JRegistry
from gome_tpu.utils.streams import mixed_stream, multi_symbol_stream
from gome_tpu_torch.bus import colwire as tcw
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.utils import faults as tfaults
from gome_tpu_torch.utils.metrics import Registry as TRegistry
from test_torch_bridge import to_torch_orders
from test_torch_frames import assert_batches_equal, batch_pair

def make_queue(pkg, kind, tmp_path, name="doOrder"):
    if kind == "memory":
        return pkg.MemoryQueue(name)
    path = str(tmp_path / ("j" if pkg is jbus else "t") / name)
    if kind == "cfile":  # the native (C++) file log of each package
        return (jnative if pkg is jbus else tbus).NativeFileQueue(name, path)
    return pkg.FileQueue(name, path)


def outcome(fn):
    """The value of fn(), or the type and message of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


def port_order(o):
    """A gome_tpu Order as the port's (trace included)."""
    return to_torch_orders([o])[0]


def plain(x):
    """Dataclasses of either package as nested tuples of plain values."""
    if dataclasses.is_dataclass(x):
        return tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "value") and isinstance(x.value, int):
        return int(x.value)
    return x


def msgs(ms):
    return [(m.offset, m.body, m.headers) for m in ms]


# -- queues -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["memory", "file", "cfile"])
def test_queue_semantics_match(kind, tmp_path):
    """Publish, batch publish, read, commit, rollback, truncate and depth,
    valid and invalid, give the same results on both packages."""
    script = [
        ("publish", b"m0"), ("publish", b"m1"),
        ("publish_batch", [b"m2", b"m3", b"m4"]), ("publish_batch", []),
        ("read_from", 0, 3), ("read_from", 3, 9), ("read_from", 9, 2),
        ("end_offset",), ("committed",), ("depth",),
        ("commit", 3), ("commit", 2), ("commit", 99), ("commit", 5),
        ("rollback", 6), ("rollback", 1), ("committed",),
        ("truncate_to", 0), ("truncate_to", 4), ("end_offset",),
        ("read_from", 1, 9), ("publish", b"m5"), ("read_from", 3, 9),
        ("depth",), ("commit", 4), ("poll_batch", 2, 0),
    ]
    results = []
    for pkg in (jbus, tbus):
        q = make_queue(pkg, kind, tmp_path)
        out = []
        for op, *args in script:
            res = outcome(lambda: getattr(q, op)(*args))
            if res[0] == "ok" and isinstance(res[1], list) and res[1] and \
                    hasattr(res[1][0], "offset"):
                res = ("ok", msgs(res[1]))
            out.append(res)
        results.append(out)
    assert results[0] == results[1]


def test_memory_queue_headers_and_compaction():
    out = []
    for pkg in (jbus, tbus):
        q = pkg.MemoryQueue("matchOrder")
        assert q.supports_headers
        q.publish(b"a", headers={"x-seq": "0"})
        q.publish(b"b")
        q.commit(1)
        res = [msgs(q.read_from(0, 5)), q.compact(), q.compact(),
               outcome(lambda: q.read_from(0, 1)),
               outcome(lambda: q.rollback(0)), msgs(q.read_from(1, 5))]
        out.append(res)
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", ["memory", "file", "cfile"])
def test_poll_batch_timing(kind, tmp_path):
    """Early return when full, a partial batch at the deadline, and a wake
    on publish from another thread."""
    q = make_queue(tbus, kind, tmp_path)
    for i in range(4):
        q.publish(f"m{i}".encode())
    t0 = time.monotonic()
    assert len(q.poll_batch(4, max_wait_s=5.0)) == 4
    assert time.monotonic() - t0 < 1.0
    q.commit(4)
    q.publish(b"only")
    t0 = time.monotonic()
    assert [m.body for m in q.poll_batch(8, max_wait_s=0.05)] == [b"only"]
    assert time.monotonic() - t0 >= 0.05
    q.commit(5)

    def later():
        time.sleep(0.05)
        q.publish(b"late")

    t = threading.Thread(target=later)
    t.start()
    got = q.poll_batch(1, max_wait_s=5.0)
    t.join()
    assert [m.body for m in got] == [b"late"]


def test_file_queue_reopen_torn_tail_and_interop(tmp_path):
    """Each package reopens the other's log (same on-disk format): offsets,
    the committed sidecar, appends after the tail; a torn tail record is
    truncated on open by both."""
    for writer, reader in ((jbus, tbus), (tbus, jbus)):
        base = str(tmp_path / f"{writer.__name__}-q")
        q = writer.FileQueue("q", base)
        for i in range(10):
            q.publish(f"msg-{i}".encode())
        q.commit(4)
        q.close()
        q2 = reader.FileQueue("q", base)
        assert (q2.end_offset(), q2.committed()) == (10, 4)
        assert q2.read_from(4, 2)[0].body == b"msg-4"
        q2.publish(b"post-restart")
        q2.close()
        with open(base + ".log", "ab") as f:
            f.write(b"\x00\x00\x00\xff partial")
        q3 = writer.FileQueue("q", base)
        assert q3.end_offset() == 11
        assert q3.read_from(10, 9)[0].body == b"post-restart"
        with open(base + ".log", "rb") as f:
            size = len(f.read())
        assert size == sum(4 + len(m.body) for m in q3.read_from(0, 99))
        q3.close()


FILE_QUEUES = {
    "port_cfile": tbus.NativeFileQueue, "port_file": tbus.FileQueue,
    "ref_cfile": jnative.NativeFileQueue, "ref_file": jbus.FileQueue,
}


@pytest.mark.parametrize("writer,reader", [
    ("port_cfile", "ref_file"), ("port_cfile", "ref_cfile"),
    ("port_cfile", "port_file"), ("ref_file", "port_cfile"),
    ("ref_cfile", "port_cfile"),
])
def test_native_file_queue_interop_batch_and_torn_tail(writer, reader,
                                                       tmp_path):
    """The port's NativeFileQueue and the other file logs read each other's
    directories: batch publishes (one write each), the committed sidecar,
    appends after a reopen, and a torn tail record truncated on open."""
    base = str(tmp_path / "q")
    q = FILE_QUEUES[writer]("q", base)
    first = [q.publish_batch([f"msg-{i}".encode() for i in range(j, j + 3)])
             for j in (0, 3, 6)] + [q.publish(b"msg-9")]
    assert first == [0, 3, 6, 9]
    q.commit(4)
    q.close()
    q2 = FILE_QUEUES[reader]("q", base)
    assert (q2.end_offset(), q2.committed()) == (10, 4)
    assert [m.body for m in q2.read_from(0, 99)] == [
        f"msg-{i}".encode() for i in range(10)]
    assert q2.publish_batch([b"post-restart", b"second"]) == 10
    q2.close()
    with open(base + ".log", "ab") as f:
        f.write(b"\x00\x00\x00\xff partial")
    for kind in (writer, reader):
        q3 = FILE_QUEUES[kind]("q", base)
        assert (q3.end_offset(), q3.committed()) == (12, 4)
        assert [m.body for m in q3.read_from(10, 9)] == [b"post-restart",
                                                          b"second"]
        with open(base + ".log", "rb") as f:
            size = len(f.read())
        assert size == sum(4 + len(m.body) for m in q3.read_from(0, 99))
        q3.close()


@pytest.mark.parametrize("point", ["filelog.append", "filelog.offset"])
def test_file_queue_fault_points_tear_alike(point, tmp_path):
    """A torn-mode fault at each FileQueue injection point writes the same
    bytes and dies the same way on both packages (the registry's exit
    replaced by a raise), and the reopened queues agree."""
    state = []
    for pkg, faults in ((jbus, jfaults), (tbus, tfaults)):
        base = str(tmp_path / f"{pkg.__name__}-q")
        q = pkg.FileQueue("q", base)
        q.publish(b"first-record")
        q.commit(1)

        def died(code):
            raise SystemExit(code)

        faults.FAULTS._exit = died
        faults.FAULTS.install(faults.FaultPlan(seed=3, faults=(
            faults.FaultSpec(point, mode="torn", at=(1,)),)))
        try:
            with pytest.raises(SystemExit) as ex:
                q.publish(b"second-record-here")
                q.commit(2)
        finally:
            faults.FAULTS.disable()
            faults.FAULTS._exit = os._exit
        q.close()
        with open(base + ".log", "rb") as f:
            log = f.read()
        with open(base + ".offset", "rb") as f:
            off = f.read()
        q2 = pkg.FileQueue("q", base)
        state.append((ex.value.code, log, off, q2.end_offset(),
                      q2.committed()))
        q2.close()
    assert state[0] == state[1]


def test_export_queue_metrics_registers_the_same_gauges():
    texts = []
    for pkg, reg in ((jbus, JRegistry()), (tbus, TRegistry())):
        q = pkg.MemoryQueue("doOrder")
        q.publish(b"a")
        q.publish(b"b")
        q.commit(1)
        from importlib import import_module

        import_module(pkg.__name__ + ".base").export_queue_metrics(q, reg)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert 'gome_bus_depth{queue="doOrder"} 1' in texts[1]


# -- JSON codecs ----------------------------------------------------------------

def _orders_with_extras():
    orders = mixed_stream(n=120, seed=8, cancel_prob=0.2, market_prob=0.15)
    return [dataclasses.replace(o, trace=f"t{i}@1.5") if i % 7 == 0 else o
            for i, o in enumerate(orders)]


def test_order_codec_bytes_and_round_trip():
    orders = _orders_with_extras()
    for o in orders:
        body = jbus.encode_order(o)
        assert tbus.encode_order(port_order(o)) == body
        assert plain(tbus.decode_order(body)) == plain(jbus.decode_order(body))
        assert tbus.decode_order(body) == port_order(o)


def test_match_result_codec_bytes_and_round_trip():
    snap = lambda types, oid, side: types.OrderSnapshot(
        uuid="u", oid=oid, symbol="s", side=types.Side(side), price=105,
        volume=3)
    for seq in (None, 0, 41):
        results = [types.MatchResult(node=snap(types, "a", 0),
                                     match_node=snap(types, "b", 1),
                                     match_volume=2, seq=seq)
                   for types in (jtypes, ttypes)]
        body = jbus.encode_match_result(results[0])
        assert tbus.encode_match_result(results[1]) == body
        assert tbus.decode_match_result(body) == results[1]


def test_decode_orders_batch_matches_on_every_input():
    """The port's Python decode against gome_tpu's (native or not) on the
    reference's fallback cases; the same ValueError for an out-of-range
    enum, and the same error on malformed JSON."""
    bodies = [jbus.encode_order(o) for o in _orders_with_extras()[:40]]
    bodies += [
        json.dumps({"Uuid": "u", "Oid": 'o"x', "Symbol": "s",
                    "Transaction": 1, "Price": 3, "Volume": 2}).encode(),
        b'{"Uuid":"a","Oid":"b","Symbol":"c","Transaction":0,"Price":1,'
        b'"Volume":1,"Extra":9}',
        b'{"Uuid":"x","Oid":"y","Symbol":"z","Transaction":1,"Price":10,'
        b'"Volume":20}',
        b'{ "Kind": 1 , "Volume": 4, "Price": 8, "Transaction": 0, '
        b'"Symbol": "w", "Oid": "q", "Uuid": "e", "Action": 1 }',
        json.dumps({"Uuid": "u", "Oid": "o", "Symbol": "сим",
                    "Transaction": 0, "Price": 1, "Volume": 1}).encode(),
    ]
    # The reference's native parser drops a Trace field; its JSON path
    # keeps it. Compare without traces, and with them against decode_order.
    untraced = lambda os: [plain(dataclasses.replace(o, trace=None))
                           for o in os]
    assert untraced(tbus.decode_orders_batch(bodies)) == \
        untraced(jbus.decode_orders_batch(bodies))
    assert tbus.decode_orders_batch(bodies) == \
        [tbus.decode_order(b) for b in bodies]
    assert tbus.decode_orders_batch([]) == []
    bad = [
        b'{"Uuid":"u","Oid":"o","Symbol":"s","Transaction":7,"Price":1,'
        b'"Volume":1}',
        b'{"Uuid":"u","Oid":"o","Symbol":"s","Transaction":0,"Price":1,'
        b'"Volume":1,"Action":5}',
        b'{"Uuid":"u","Oid":"o","Symbol":"s","Transaction":0,"Price":007,'
        b'"Volume":1}',
        b'not json',
    ]
    for body in bad:
        got = outcome(lambda: tbus.decode_orders_batch([bodies[0], body]))
        want = outcome(lambda: jbus.decode_orders_batch([bodies[0], body]))
        assert got[0] == want[0] != "ok", body
    with pytest.raises(ValueError):
        tbus.decode_orders_batch([bad[0]])


# -- columnar frames ------------------------------------------------------------

def assert_cols_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            assert got[k].dtype == w.dtype, k
        else:
            assert list(got[k]) == list(w) if isinstance(w, list) \
                else got[k] == w, k


@pytest.mark.parametrize("traced", [False, True])
def test_order_frames_byte_equal_and_cross_decode(traced):
    orders = multi_symbol_stream(n=300, n_symbols=9, seed=4, cancel_prob=0.2)
    if traced:
        orders = _orders_with_extras()
    frame = jcw.encode_orders(orders)
    assert tcw.encode_orders([port_order(o) for o in orders]) == frame
    assert frame[:4] == (b"GCO3" if traced else b"GCO2")
    assert tcw.is_frame(frame) and not tcw.is_frame(b'{"Uuid":1}')
    assert_cols_equal(tcw.decode_order_frame(frame),
                      jcw.decode_order_frame(frame))
    want = jbus.decode_message_orders(frame)
    got = tbus.decode_message_orders(frame)
    assert plain(got) == plain(want)
    body = jbus.encode_order(orders[0])
    assert plain(tbus.decode_message_orders(body)) == \
        plain(jbus.decode_message_orders(body))


def test_order_blocks_frames_byte_equal_and_cross_decode():
    """GCO4: blocks encoded by each package are byte-equal, the framed
    result too, and both decoders merge them the same way (one block and
    several)."""
    orders = multi_symbol_stream(n=240, n_symbols=7, seed=6, cancel_prob=0.2)
    blocks = {}
    for name, cw, conv in (("j", jcw, lambda os: os),
                           ("t", tcw, lambda os: [port_order(o) for o in os])):
        out = []
        for i in range(0, len(orders), 80):
            cols = jcw.decode_order_frame(jcw.encode_orders(orders[i:i + 80]))
            out.append(cw.encode_order_block(
                cols["n"], cols["action"], cols["side"], cols["kind"],
                cols["price"], cols["volume"], list(cols["symbols"]),
                cols["symbol_idx"], list(cols["uuids"]), cols["uuid_idx"],
                cols["oids"]))
        blocks[name] = out
    assert blocks["j"] == blocks["t"]
    for part in (blocks["j"][:1], blocks["j"]):
        frame = jcw.encode_order_frame_blocks(part)
        assert tcw.encode_order_frame_blocks(part) == frame
        assert_cols_equal(tcw.decode_order_frame(frame),
                          jcw.decode_order_frame(frame))
    with pytest.raises(ValueError):
        tcw.encode_order_frame_blocks([])
    for bad in (b"GXXX" + b"\0" * 8, b"GCE1\0\0\0\0"):
        assert outcome(lambda: tcw.decode_order_frame(bad)) == \
            outcome(lambda: jcw.decode_order_frame(bad))


def test_event_frames_byte_equal_and_cross_decode():
    """EVENT frames of equal EventBatches (both packages' frame paths on
    the same ORDER frames) are byte-equal, unstamped (GCE1) and stamped
    (GCE2), and each package decodes the other's to equal results."""
    orders = multi_symbol_stream(n=300, n_symbols=5, seed=11, cancel_prob=0.2)
    j, t = batch_pair(32, 8, 16, 8)
    n_events = 0
    for i in range(0, len(orders), 40):
        cols = jcw.decode_order_frame(jcw.encode_orders(orders[i:i + 40]))
        jb, tb = jframes.apply_frame_fast(j, cols), \
            tframes.apply_frame_fast(t, cols)
        assert_batches_equal(tb, jb)
        for seq0 in (None, n_events):
            frame = jcw.encode_event_frame(jb, seq0=seq0)
            assert frame[:4] == (b"GCE1" if seq0 is None else b"GCE2")
            assert tcw.encode_event_frame(tb, seq0=seq0) == frame
            got, want = tcw.decode_event_frame(frame), \
                jcw.decode_event_frame(frame)
            assert_batches_equal(got, want)
            assert got.seq0 == want.seq0 == seq0
            assert plain(got.to_results()) == plain(want.to_results())
            assert got.to_json_lines() == want.to_json_lines()
        n_events += len(jb)
    assert n_events > 0
    with pytest.raises(ValueError):
        tcw.decode_event_frame(b"GCO2\0\0\0\0")
