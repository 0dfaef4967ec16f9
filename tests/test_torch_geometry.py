"""The engine's geometry warm-up (BatchEngine.prewarm_geometry,
reset_geometry_floors, ensure_cap; frames.precompile_combos;
MatchEngine.save_geometry / load_geometry) against gome_tpu's, on the CPU:
the same Zipf frames leave equal manifests and equal saved JSON in both
packages, each package loads the other's manifest, a warmed engine's events
equal a cold one's, and the grow-only merges and the cap ceiling behave
alike. Exact equality throughout."""

import json

import jax.numpy as jnp
import pytest

from gome_tpu.engine import BookConfig as JConfig
from gome_tpu.engine.batch import CapacityError as JCapacityError
from gome_tpu.engine.orchestrator import MatchEngine as JEngine
from gome_tpu.utils.streams import multi_symbol_stream
from gome_tpu_torch.engine import BookConfig, MatchEngine
from gome_tpu_torch.engine import frames as tframes
from gome_tpu_torch.engine.batch import CapacityError
from test_torch_frames import assert_batches_equal, frame_of

#: Cap 128 over a cap ladder of two classes (64, 128); 96 symbols in 128
#: lanes, so the dense path runs.
GEOMETRY = dict(cap=128, k=4, n_slots=128, max_t=8)


def engines(dtype="int64", **kw):
    """gome_tpu's MatchEngine and the port's (on the CPU), same geometry."""
    g = dict(GEOMETRY, **kw)
    j = JEngine(JConfig(cap=g["cap"], max_fills=g["k"],
                        dtype=jnp.dtype(dtype)),
                n_slots=g["n_slots"], max_t=g["max_t"])
    t = MatchEngine(BookConfig(cap=g["cap"], max_fills=g["k"], dtype=dtype),
                    n_slots=g["n_slots"], max_t=g["max_t"], device="cpu")
    return j, t


def zipf_frames(n=1600, chunk=400, seed=11):
    orders = multi_symbol_stream(n=n, n_symbols=96, zipf_a=1.2,
                                 cancel_prob=0.3, seed=seed)
    return [frame_of(orders[i:i + chunk]) for i in range(0, n, chunk)]


def run(eng, frames) -> list:
    out = []
    for cols in frames:
        eng.mark_frame(cols)
        out.append(eng.process_frame(cols, fast=True))
    return out


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """Both packages after the same frames, each manifest saved."""
    d = tmp_path_factory.mktemp("geometry")
    j, t = engines()
    frames = zipf_frames()
    for got, want in zip(run(t, frames), run(j, frames)):
        assert_batches_equal(got, want)
    paths = {"j": str(d / "j.json"), "t": str(d / "t.json")}
    j.save_geometry(paths["j"])
    t.save_geometry(paths["t"])
    return j, t, frames, paths


def test_manifests_equal_after_the_same_frames(warmed):
    j, t, _, paths = warmed
    tm, jm = t.batch.shape_manifest(), j.batch.shape_manifest()
    assert tm["floors"] == jm["floors"]
    assert tm["combos"] == [tuple(c) for c in jm["combos"]]
    assert len(tm["combos"]) > 1 and {c[2] for c in tm["combos"]} == {64, 128}
    docs = {side: open(p).read() for side, p in paths.items()}
    assert json.loads(docs["t"]) == json.loads(docs["j"])
    assert docs["t"] == docs["j"]


@pytest.mark.parametrize("source", ["j", "t"])
def test_each_package_loads_either_manifest(warmed, source):
    """A fresh engine of each package loads the manifest either package
    saved: the same floors, every combo replayed and recorded."""
    _, t0, _, paths = warmed
    j, t = engines()
    combos = t0.batch.combos()
    assert t.load_geometry(paths[source]) == len(combos)
    assert j.load_geometry(paths[source]) == len(combos)
    assert t.batch.geometry_floors() == j.batch.geometry_floors() \
        == t0.batch.geometry_floors()
    assert t.batch.combos() == [tuple(c) for c in j.batch.combos()] == combos
    # Replay mutates nothing: the books are still empty.
    assert int(t.batch.books.count.sum()) == 0


def test_load_without_presize_keeps_the_boot_cap(warmed):
    """presize_cap=False (bench.py --service's call): the boot storage
    stays, combos above it are skipped, the floors still merge; the same
    in both packages."""
    _, t0, _, paths = warmed
    j, t = engines()
    got = t.load_geometry(paths["t"], presize_cap=False)
    assert got == j.load_geometry(paths["t"], presize_cap=False)
    assert t.batch.config.cap == j.batch.config.cap == GEOMETRY["cap"]
    assert got == sum(1 for c in t0.batch.combos() if c[2] <= GEOMETRY["cap"])
    assert t.batch.geometry_floors() == j.batch.geometry_floors()


def test_loaded_engine_runs_the_cold_engines_events(warmed):
    """Loading the manifest changes no event: a warmed port engine, a cold
    port engine and gome_tpu's give the same batches, and the warmed one
    dispatches no combo the manifest did not hold."""
    _, t0, frames, paths = warmed
    j, cold = engines()
    _, hot = engines()
    assert hot.load_geometry(paths["t"]) == len(t0.batch.combos())
    want = run(j, frames)
    for a, b, w in zip(run(hot, frames), run(cold, frames), want):
        assert_batches_equal(a, w)
        assert_batches_equal(b, w)
    assert hot.batch.combos() == t0.batch.combos()
    assert hot.batch.combo_count() == len(t0.batch.combos())


def test_precompile_skips_stale_combos_like_the_reference(warmed):
    """A combo of another tuple layout, a full grid at another lane count
    and a cap class above the storage cap are skipped one by one."""
    _, t0, _, _ = warmed
    good = t0.batch.combos()
    stale = [(1, 2, 3), (64, 8, 64, False, 64, 4, 64, 64, 8),
             (8, 8, 1024, True, 64, 4, 64, 64, 8)]
    j, t = engines()
    got = tframes.precompile_combos(t.batch, good + stale)
    from gome_tpu.engine import frames as jframes

    assert got == jframes.precompile_combos(j.batch, good + stale) == len(good)
    assert t.batch.combos() == good


def test_prewarm_reset_and_ensure_cap_match(tmp_path):
    j, t = engines(dtype="int32")
    for eng in (j.batch, t.batch):
        eng.prewarm_geometry(rows_floor=20, t_floor={128: 3, 64: 100},
                             fills_buf=300, cancels_buf={256: 70})
        # Grow-only: a smaller floor never lowers one; clamped to the
        # usable range (rows past n_slots).
        eng.prewarm_geometry(rows_floor={128: 9, 64: 4096}, fills_buf=65)
    assert t.batch.geometry_floors() == j.batch.geometry_floors()
    assert t.batch.geometry_floors()["rows_floor"] == {128: 32, 64: 128}
    for eng in (j.batch, t.batch):
        eng.ensure_cap(200)
    assert t.batch.config.cap == j.batch.config.cap == 256
    assert tuple(t.batch.books.price.shape) == (128, 2, 256)
    for side, err in ((j, JCapacityError), (t, CapacityError)):
        with pytest.raises(err, match="exceeds max_cap"):
            side.batch.ensure_cap(side.batch.max_cap * 2)
    assert t.batch.config.cap == 256
    frames = zipf_frames(n=400)
    for got, want in zip(run(t, frames), run(j, frames)):
        assert_batches_equal(got, want)
    assert t.batch.combos() == [tuple(c) for c in j.batch.combos()]
    for eng in (j.batch, t.batch):
        eng.reset_geometry_floors()
    assert t.batch.geometry_floors() == j.batch.geometry_floors()
    assert t.batch.combo_count() == j.batch.combo_count() > 0
    for eng in (j.batch, t.batch):
        eng.reset_geometry_floors(combos=True)
    assert t.batch.combo_count() == j.batch.combo_count() == 0
    # An absent or broken manifest loads nothing, in both packages.
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for eng in (j, t):
        assert eng.load_geometry(str(tmp_path / "absent.json")) == 0
        assert eng.load_geometry(str(bad)) == 0
