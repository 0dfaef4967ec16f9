"""The port's native host layer (gome_tpu_torch/native, engine.nativehost,
NativePrePool) on the CPU: its C++ interner and pre-pool against gome_tpu's
(native/hostops.cc) and against the port's own Python Interner and
LocalPrePool, on the same inputs made with numpy from a seed (the cases of
tests/test_nativehost.py on both packages); its grid pack, occurrence pass
and compact decode against the port's numpy branches on random frames; and
its build: a failed compile raises, only a missing g++ selects the Python
classes, several processes reaching the first build together share one
compile, and the library the port loads is its own."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gome_tpu.engine import nativehost as jnativehost
from gome_tpu.engine.prepool import NativePrePool as JNativePrePool
from gome_tpu_torch.engine import BookConfig, frames, nativehost
from gome_tpu_torch.engine.batch import BatchEngine
from gome_tpu_torch.engine.host import Interner
from gome_tpu_torch.engine.nativehost import NativeInterner
from gome_tpu_torch.engine.prepool import (
    LocalPrePool,
    NativeConsumed,
    NativePrePool,
    make_prepool,
)
from gome_tpu_torch.native import build
from test_nativehost import _frame_cols, _keys_of, _local_admit
from test_torch_frames import frame_of

ROOT_OF_REPO = pathlib.Path(__file__).resolve().parent.parent


def test_interner_parity_randomized():
    rng = np.random.default_rng(3)
    py, nat, ref = Interner(), NativeInterner(), jnativehost.NativeInterner()
    words = [f"w{int(rng.integers(0, 500))}" for _ in range(2_000)]
    for w in words:
        assert py.intern(w) == nat.intern(w) == ref.intern(w)
    assert len(py) == len(nat) == len(ref)
    assert py.to_list() == nat.to_list() == ref.to_list()
    for i in range(len(py)):
        assert py.lookup(i) == nat.lookup(i) == ref.lookup(i)
    assert py.get("w0") == nat.get("w0") == ref.get("w0")
    assert py.get("missing") is None and nat.get("missing") is None
    # batch intern matches one-by-one interning and the reference's batch
    more = np.array(
        [f"x{int(rng.integers(0, 100))}".encode() for _ in range(500)],
        dtype="S8",
    )
    ids_nat = nat.intern_batch(more)
    np.testing.assert_array_equal(ids_nat, ref.intern_batch(more))
    ids_py = np.array([py.intern(b.decode()) for b in more.tolist()])
    np.testing.assert_array_equal(ids_nat, ids_py)
    # gather round-trips, padded to the requested ids' width
    some = np.array([1, 5, 0, len(py) - 1], np.int64)
    got = nat.gather_padded(some)
    assert got.dtype == ref.gather_padded(some).dtype
    assert [s.decode() for s in got.tolist()] == [
        py.lookup(int(i)) for i in some
    ]
    # table view quacks like the list
    assert nat.table[3] == py.table[3]
    assert list(nat.table) == list(py.table) == list(ref.table)
    # from_list round trip
    nat2 = NativeInterner.from_list(py.to_list())
    assert nat2.to_list() == py.to_list()
    assert Interner.from_list(nat2.to_list()).to_list() == py.to_list()
    with pytest.raises(IndexError):
        nat.lookup(10_000_000)
    with pytest.raises(IndexError):
        nat.gather_padded(np.array([10_000_000]))


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_prepool_frame_admission_parity(seed):
    rng = np.random.default_rng(seed)
    cols = _frame_cols(rng, 400)
    keys = _keys_of(cols)
    # Mark a random subset (some ADDs marked, some not; some DELs racing).
    marked = [k for k in keys if rng.random() < 0.7]
    local = LocalPrePool(marked)
    native, ref = NativePrePool(), JNativePrePool()
    native |= marked
    ref |= marked
    assert native == set(local) == set(ref)

    keep_l, consumed_l = _local_admit(local, cols)
    keep_n, consumed_n = native.consume_frame(cols)
    keep_r, consumed_r = ref.consume_frame(cols)
    np.testing.assert_array_equal(np.asarray(keep_n), keep_l)
    np.testing.assert_array_equal(np.asarray(keep_n), np.asarray(keep_r))
    assert isinstance(consumed_n, NativeConsumed)
    assert set(consumed_n) == consumed_l == set(consumed_r)
    assert len(consumed_n) == len(consumed_l)
    np.testing.assert_array_equal(consumed_n.sel, consumed_r.sel)
    assert native == set(local) == set(ref)  # post-admission pool state

    # Rollback: restoring consumed marks converges the pools again.
    local |= consumed_l
    native |= consumed_n
    ref |= consumed_r
    assert native == set(local) == set(ref) == set(marked)


def test_prepool_mark_frame_matches_per_order_marks():
    rng = np.random.default_rng(9)
    cols = _frame_cols(rng, 300)
    a, ref = NativePrePool(), JNativePrePool()
    a.mark_frame(cols)
    ref.mark_frame(cols)
    b = LocalPrePool()
    for key, act in zip(_keys_of(cols), cols["action"].tolist()):
        if act == 1:  # ADDs only
            b.add(key)
    assert a == set(b) == set(ref)
    local = LocalPrePool()
    local.mark_frame(cols)
    assert a == local
    a.unmark_frame(cols)
    local.unmark_frame(cols)
    assert len(a) == len(local) == 0


def test_prepool_set_protocol():
    p = NativePrePool()
    k = ("eth2usdt", "u1", "42")
    assert k not in p
    p.add(k)
    p.add(k)  # idempotent
    assert k in p and len(p) == 1
    p.discard(("nope",) * 3)  # no-op
    assert sorted(p) == [k]
    p.update([("a", "b", "c")])
    assert len(p) == 2 and p == {k, ("a", "b", "c")}
    assert p != {k}
    assert p.consume_batch([k, k]) == [True, False]
    p.clear()
    assert len(p) == 0 and list(p) == []
    assert p.consume_batch([k]) == [False]


def test_prepool_rejects_an_index_past_its_dictionary():
    rng = np.random.default_rng(4)
    cols = _frame_cols(rng, 50)
    cols["symbol_idx"] = cols["symbol_idx"].copy()
    cols["symbol_idx"][7] = len(cols["symbols"])
    with pytest.raises(ValueError):
        NativePrePool().consume_frame(cols)


def test_prepool_concurrent_mark_and_consume():
    """The gateway marks WHILE the consumer admits (the C++ mutex's reason
    to exist): a producer thread marks each frame's keys then hands the
    frame over; the consumer thread admits it. Every mark written is
    consumed once: the pool ends empty and each frame admits no more ADDs
    than it has distinct marked keys."""
    import queue
    import threading

    rng = np.random.default_rng(21)
    pool = NativePrePool()
    frames_ = [
        _frame_cols(rng, 200, nop_prob=0.0, del_prob=0.0) for _ in range(30)
    ]
    handoff: queue.Queue = queue.Queue()

    def gateway():
        for cols in frames_:
            pool.mark_frame(cols)
            handoff.put(cols)
        handoff.put(None)

    admitted = dropped = 0
    t = threading.Thread(target=gateway)
    t.start()
    while True:
        cols = handoff.get(timeout=60)
        if cols is None:
            break
        keep, _ = pool.consume_frame(cols)
        admitted += int(np.asarray(keep).sum())
        dropped += cols["n"] - int(np.asarray(keep).sum())
        try:  # iteration under concurrent marking raises, never garbles
            len(list(pool))
        except RuntimeError:
            pass
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(pool) == 0
    assert admitted + dropped == sum(c["n"] for c in frames_)
    assert 0 < admitted <= sum(len(set(_keys_of(c))) for c in frames_)


# -- the frame-path passes against the port's numpy branches ---------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occurrences_match_numpy(seed):
    rng = np.random.default_rng(seed)
    n_lanes = int(rng.integers(1, 40))
    lanes = rng.integers(0, n_lanes, 3_000).astype(np.int64)
    keep = rng.random(3_000) < 0.8
    np.testing.assert_array_equal(
        nativehost.occurrences(lanes, keep, n_lanes),
        frames._occurrences_numpy(lanes, keep),
    )
    np.testing.assert_array_equal(
        nativehost.occurrences(lanes, None, n_lanes),
        frames._occurrences_numpy(lanes, np.ones(3_000, bool)),
    )


def _recorded_fast_run(seed, monkeypatch, dtype):
    """Run a random Zipf flow through the port's fast frame path (native
    branches) and record every pack_grid and compact-decode call."""
    import torch

    from gome_tpu.utils.streams import mixed_stream, multi_symbol_stream

    orders = multi_symbol_stream(n=900, n_symbols=40, seed=seed, zipf_a=1.2,
                                 cancel_prob=0.3) + mixed_stream(
        n=300, seed=seed, cancel_prob=0.2, market_prob=0.2)
    eng = BatchEngine(
        BookConfig(cap=32, max_fills=4,
                   dtype={"int32": torch.int32, "int64": torch.int64}[dtype]),
        n_slots=64, max_t=8, device="cpu",
    )
    packs, decodes = [], []
    inner_pack, inner_decode = nativehost.pack_grid, frames._decode_compact

    def pack(*args):
        out = inner_pack(*args)
        packs.append((args, out))
        return out

    def decode(*args):
        out = inner_decode(*args)
        decodes.append((args, out))
        return out

    monkeypatch.setattr(nativehost, "pack_grid", pack)
    monkeypatch.setattr(frames, "_decode_compact", decode)
    for i in range(0, len(orders), 300):
        frames.apply_frame_fast(eng, frame_of(orders[i:i + 300]))
    monkeypatch.undo()
    assert packs and decodes
    return packs, decodes


@pytest.mark.parametrize("seed,dtype", [(1, "int32"), (2, "int64")])
def test_pack_grid_and_decode_compact_match_numpy(seed, dtype, monkeypatch):
    packs, decodes = _recorded_fast_run(seed, monkeypatch, dtype)
    for args, (cols, flat, meta) in packs:
        a, idx, row_of, t_off, t_grid, n_rows, m_pad, dt, _, _ = args
        t_sub = a["t"][idx]
        sel = idx[(t_sub >= t_off) & (t_sub < t_off + t_grid)]
        want = frames._pack_grid_numpy(a, sel, row_of, t_off, t_grid,
                                       n_rows, m_pad, dt)
        for got_arr, want_arr in zip((cols, flat), want[:2]):
            np.testing.assert_array_equal(got_arr, want_arr)
            assert got_arr.dtype == want_arr.dtype
        # submit_frame adds "_n_rows" to the meta dict once it is packed.
        assert meta.keys() - {"_n_rows"} == want[2].keys()
        for name in want[2]:
            np.testing.assert_array_equal(meta[name], want[2][name],
                                          err_msg=name)
    monkeypatch.setattr(nativehost, "available", lambda: False)
    assert any(len(out["arrival"]) for _, out in decodes)
    for args, out in decodes:
        want = frames._decode_compact(*args)
        assert out.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(out[name], want[name], err_msg=name)
            assert out[name].dtype == want[name].dtype, name


def test_frame_arrays_equal_across_branches(monkeypatch):
    """_frame_arrays (oid intern_batch, occurrences) on two engines, one
    per branch: every array equal."""
    from gome_tpu.utils.streams import multi_symbol_stream

    orders = multi_symbol_stream(n=400, n_symbols=12, seed=7, zipf_a=1.2,
                                 cancel_prob=0.3)
    cols = frame_of(orders)
    nat = BatchEngine(BookConfig(cap=32, max_fills=4), n_slots=16, max_t=8,
                      device="cpu")
    monkeypatch.setattr(nativehost, "available", lambda: False)
    py = BatchEngine(BookConfig(cap=32, max_fills=4), n_slots=16, max_t=8,
                     device="cpu")
    assert type(py.oids) is Interner and type(nat.oids) is NativeInterner
    want = frames._frame_arrays(py, cols)
    monkeypatch.undo()
    got = frames._frame_arrays(nat, cols)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# -- the build -----------------------------------------------------------------


def test_failed_compile_raises(monkeypatch, tmp_path):
    """A compiler that is found but fails: the build raises with its
    output, and the engine's factories raise too — they never hand out
    the Python classes."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(build, "CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="failed to build"):
        build.load()
    with pytest.raises(RuntimeError):
        nativehost.available()
    with pytest.raises(RuntimeError):
        nativehost.make_interner()
    with pytest.raises(RuntimeError):
        make_prepool()
    assert not any(p.name.endswith(".so") for p in tmp_path.rglob("*"))


def test_missing_compiler_selects_the_python_classes(monkeypatch):
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "CXX", "no-such-compiler-gome")
    assert build.load() is None
    assert not nativehost.available()
    assert type(nativehost.make_interner()) is Interner
    assert type(nativehost.make_interner(["a", "b"])) is Interner
    assert type(make_prepool()) is LocalPrePool
    eng = BatchEngine(BookConfig(cap=8, max_fills=2), n_slots=4, max_t=4,
                      device="cpu")
    assert type(eng.oids) is Interner


def test_concurrent_first_build_compiles_once(tmp_path):
    """Three processes reach the first build of an empty build root
    together: all load the library, one compiles, no temporary file is
    left."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT_OF_REPO)!r})
        from gome_tpu_torch.native import build
        build.BUILD_ROOT = {str(tmp_path)!r}
        assert build.load() is not None
        print(build.build_seconds is not None)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert sorted(o.strip() for o, _ in outs) == ["False", "False", "True"]
    files = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert files == ["libgome_torch_host.so", "lock"]


def test_the_loaded_library_is_the_ports_own():
    """In a fresh process the port maps its own library from
    gome_tpu_torch/native/_build/ and never the reference's
    native/build/libgome_native.so."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT_OF_REPO)!r})
        from gome_tpu_torch.engine import nativehost
        from gome_tpu_torch.bus import native_available
        from gome_tpu_torch.bus.ordercodec import decode_orders_batch
        assert nativehost.available() and native_available()
        decode_orders_batch([b'{{"Uuid":"u","Oid":"o","Symbol":"s",'
                             b'"Transaction":0,"Price":1,"Volume":1}}'])
        print(open("/proc/self/maps").read())
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    mapped = {line.split()[-1] for line in proc.stdout.splitlines()
              if line.rstrip().endswith(".so")}
    ours = [p for p in mapped
            if "/gome_tpu_torch/native/_build/" in p
            and p.endswith("/libgome_torch_host.so")]
    assert len(ours) == 1, mapped
    assert not [p for p in mapped if "libgome_native" in p], mapped
