"""The port's measured-roofline profiler (gome_tpu_torch/obs/profiler.py)
on the CPU: the trace parser gives gome_tpu's result, dict for dict, on the
reference's golden traces, and hand-computed unions on torch-shaped ones
(kernels tied to their launching thread, cpu_op events in a trace without
kernels); a real capture of the cost model's entries yields ``cpu_ops``
rows; the singleton's ring, gauges and payload; the disabled hook
allocates nothing; and the per-shard telemetry on a CPU mesh of 2 equals
gome_tpu's."""

import os
import sys

import numpy as np
import pytest
import torch

import gome_tpu.obs.profiler as jprofiler
import gome_tpu_torch.obs.profiler as tprofiler
from gome_tpu_torch.obs import costmodel
from gome_tpu_torch.utils.metrics import REGISTRY
from test_profiler import _golden_events

PREFIX = tprofiler.ANNOTATION_PREFIX


@pytest.fixture(autouse=True)
def disarmed():
    for p in (jprofiler.PROFILER, tprofiler.PROFILER):
        p.disable()
    yield
    for p in (jprofiler.PROFILER, tprofiler.PROFILER):
        p.disable()


def split_windows():
    """tests/test_profiler.py's two-window trace."""
    return [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "ts": 100, "dur": 100,
         "name": PREFIX + "batch_step"},
        {"ph": "X", "pid": 1, "ts": 400, "dur": 100,
         "name": PREFIX + "batch_step"},
        {"ph": "X", "pid": 1, "ts": 150, "dur": 20, "name": "fusion.0"},
        {"ph": "X", "pid": 1, "ts": 250, "dur": 50, "name": "fusion.1"},
        {"ph": "X", "pid": 1, "ts": 430, "dur": 40, "name": "fusion.2"},
    ]


@pytest.mark.parametrize("events, labels", [
    (_golden_events(), ["lane_scan", "compact_accum", "missing"]),
    (split_windows(), ["batch_step"]),
])
def test_reference_traces_parse_as_the_reference(events, labels):
    assert jprofiler.ANNOTATION_PREFIX == PREFIX
    got = tprofiler.parse_trace_events(events, labels)
    assert got == jprofiler.parse_trace_events(events, labels)
    assert got[labels[0]]["windows"] >= 1


def cuda_trace():
    """A torch-shaped trace of one window on the card: the window's own
    kernels (two kernels and a copy straddling the window's end), a
    kernel the consumer thread launched meanwhile on its stream, two
    kernels with no launch record (one on the window's stream, one on the
    consumer's), the host-side cpu_ops (not device time in a trace with
    kernels) and the GPU-side copy of the annotation (not a window)."""
    def x(cat, name, pid, tid, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
             "ts": ts, "dur": dur, "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        return e

    return [
        {"ph": "M", "name": "process_name", "pid": 100,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 100,
         "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0,
         "args": {"labels": "GPU 0"}},
        x("user_annotation", PREFIX + "batch_step", 100, 1, 1000, 1000),
        x("gpu_user_annotation", PREFIX + "batch_step", 0, 7, 1005, 990),
        x("cpu_op", "aten::add", 100, 1, 1100, 300),
        x("cuda_runtime", "cudaLaunchKernel", 100, 1, 1100, 5, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 100, 1, 1300, 5, corr=2),
        x("cuda_runtime", "cudaMemcpyAsync", 100, 1, 1500, 5, corr=3),
        x("cuda_runtime", "cudaLaunchKernel", 100, 2, 1150, 5, corr=4),
        x("kernel", "gome_match_step", 0, 7, 1120, 200, corr=1),
        x("kernel", "elementwise_kernel", 0, 7, 1330, 50, corr=2),
        x("gpu_memcpy", "Memcpy DtoH", 0, 7, 1900, 300, corr=3),
        x("kernel", "consumer_kernel", 0, 8, 1200, 400, corr=4),
        x("kernel", "orphan_kernel", 0, 7, 1400, 10),
        x("kernel", "consumer_orphan", 0, 8, 1450, 10),
    ]


def stale_tid_trace():
    """``cuda_trace`` as Kineto wrote it for a capture after the first
    that started on a new thread: every CUDA runtime call filed under
    one stale thread id, and the capture's stream named by a
    STREAM_MARKER kernel launched before the window."""
    events = []
    for e in cuda_trace():
        if e.get("cat") == "cuda_runtime":
            e = dict(e, tid=99)
        events.append(e)
    events.append({"ph": "X", "cat": "kernel", "name": "spin_kernel(long)",
                   "pid": 0, "tid": 7, "ts": 900, "dur": 2, "args": {}})
    return events


def cpu_trace():
    """A torch-shaped CPU trace: nested cpu_ops on the window's thread
    (union, not sum), one on another thread (excluded), a Python event."""
    def op(name, tid, ts, dur, cat="cpu_op"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid,
                "ts": ts, "dur": dur, "args": {}}

    return [
        {"ph": "M", "name": "process_name", "pid": 100,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 100,
         "args": {"labels": "CPU"}},
        op(PREFIX + "lane_scan", 1, 0, 100, cat="user_annotation"),
        op("aten::matmul", 1, 10, 50),
        op("aten::mm", 1, 12, 40),
        op("aten::add", 1, 70, 10),
        op("aten::index", 2, 20, 60),
        op("run_entry", 1, 5, 90, cat="python_function"),
        op("aten::sub", 1, 150, 10),
    ]


def test_torch_traces_hand_computed():
    gpu = tprofiler.parse_trace_events(cuda_trace(), ["batch_step"])
    assert gpu == {"batch_step": {
        "windows": 1, "wall_us": 1000.0,
        # 200 + 50 + the copy's 100 inside the window + the unrecorded
        # kernel on the window's stream 10; the consumer's two count
        # nothing
        "device_us": 360.0, "by_device": {"GPU 0": 360.0},
        "events": 4, "top_op": "gome_match_step"}}
    assert tprofiler.window_event_names(cuda_trace(), "batch_step") == [
        "gome_match_step", "elementwise_kernel", "Memcpy DtoH",
        "orphan_kernel"]
    stale = stale_tid_trace()
    streams = tprofiler.marker_streams(stale)
    assert streams == [(0, 7)]
    # By launching thread nothing is the window's; by its stream the
    # window's own events are found again (the consumer's still apart).
    assert tprofiler.parse_trace_events(stale, ["batch_step"])[
        "batch_step"]["events"] == 0
    assert tprofiler.parse_trace_events(
        stale, ["batch_step"], streams=streams) == gpu
    assert tprofiler.window_event_names(
        stale, "batch_step", streams=[[0, 7]]) == [
        "gome_match_step", "elementwise_kernel", "Memcpy DtoH",
        "orphan_kernel"]
    cpu = tprofiler.parse_trace_events(cpu_trace(), ["lane_scan", "none"])
    assert cpu["lane_scan"] == {
        "windows": 1, "wall_us": 100.0, "device_us": 60.0,
        "by_device": {"CPU": 60.0}, "events": 3, "top_op": "aten::matmul"}
    assert cpu["none"]["windows"] == 0 and cpu["none"]["top_op"] is None


def test_capture_yields_cpu_op_rows(tmp_path):
    tprofiler.PROFILER.install(keep_n=2, log_dir=str(tmp_path))
    rep = tprofiler.PROFILER.capture_report("int32", repeats=2, device="cpu")
    assert (rep["platform"], rep["device"]) == ("cpu", "cpu")
    assert rep["peaks"]["peak_gflops"] > 0 and rep["peaks"]["peak_gbps"] > 0
    assert rep["peaks"]["source"] in ("calibrated", "env", "env+calibrated")
    assert list(rep["entries"]) == list(costmodel.RATCHET_ENTRIES)
    for row in rep["entries"].values():
        assert row["device_time_source"] == "cpu_ops", row
        assert row["device_us_per_call"] > 0 and row["trace_events"] > 0
        assert row["top_op"].startswith("aten::")
        assert row["flops"] and row["bytes_accessed"]
        assert 0 < row["achieved_gflops"] <= rep["peaks"]["peak_gflops"] * 1.5
        assert 0 < row["achieved_gbps"] <= rep["peaks"]["peak_gbps"] * 1.5
        assert 0 < row["efficiency_pct"] <= 150.0
    assert rep["run_dir"].startswith(str(tmp_path))
    assert os.path.exists(rep["perfetto_trace"])
    assert tprofiler.latest_run_dir(str(tmp_path)) == rep["run_dir"]
    assert tprofiler.load_trace_events(rep["run_dir"])
    assert tprofiler.PROFILER.last_report() is rep
    payload = tprofiler.PROFILER.payload(dtype="int32", device="cpu")
    # The count is the process-wide PROFILER's (earlier captures count).
    assert payload["enabled"] and payload["captures"] >= 1
    assert payload["report"] is rep
    metrics = REGISTRY.render()
    for name in ("gome_profile_captures_total", "gome_profile_device_us",
                 "gome_profile_efficiency_pct"):
        assert name in metrics
    assert 'entry="batch_step"' in metrics
    block = tprofiler.bench_measured("int32", repeats=2, device="cpu")
    assert block["platform"] == "cpu" and block["entries"]
    for row in block["entries"].values():
        assert set(row) == {"device_us_per_call", "achieved_gflops",
                            "achieved_gbps", "efficiency_pct"}
    assert tprofiler.PROFILER.payload()["captures"] == payload["captures"] + 1


@pytest.mark.parametrize("call", [
    lambda: tprofiler.capture().__enter__(),
    lambda: tprofiler.machine_peaks(refresh=True),
    lambda: costmodel.canonical_entries("int32"),
], ids=["capture", "machine_peaks", "canonical_entries"])
def test_entry_points_default_to_the_card(call, monkeypatch):
    """With no ``device`` each entry point asks for the CUDA card: with
    none it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_capture_with_no_device_traces_cuda(tmp_path, monkeypatch):
    """``capture()`` with no arguments asks torch.profiler for CUDA
    activity (a stand-in profiler records what it was asked for)."""
    import gzip
    import json

    from torch.profiler import ProfilerActivity

    asked, warm = [], []

    class Stub:
        def __init__(self, activities, on_trace_ready, schedule):
            asked.extend(activities)
            self.ready, self.steps = on_trace_ready, 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1
            if self.steps == 2:  # warm-up, then the recorded step
                self.ready(self)

        def export_chrome_trace(self, path):
            with gzip.open(path, "wt") as f:
                json.dump({"traceEvents": []}, f)

    class Stream:
        def synchronize(self):
            warm.append("sync")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: warm.append("launch"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.profiler, "profile", Stub)
    with tprofiler.capture(str(tmp_path)) as cap:
        pass
    assert asked == [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    assert warm == ["launch", "sync"] * tprofiler.WARMUP_LAUNCHES
    assert cap.run_dir.startswith(str(tmp_path)) and cap.perfetto


def test_disabled_profiler_is_inert():
    p = tprofiler.PROFILER
    assert not p.enabled
    assert p.shard_report() == {"enabled": False}
    assert p.payload() == jprofiler.PROFILER.payload() == {
        "enabled": False, "captures": 0, "report": None,
        "shards": {"enabled": False}}


def test_disabled_shard_hook_allocates_nothing():
    counts = np.array([3, 1])

    def drill(n):
        i = 0
        while i < n:
            tprofiler.PROFILER.note_shard_dispatch(2, 8, counts)
            i += 1

    drill(64)
    before = sys.getallocatedblocks()
    drill(200)
    after = sys.getallocatedblocks()
    assert after - before <= 2, f"hot-path hook allocated {after - before}"


def test_shard_telemetry_on_two_shard_mesh():
    """The same dense dispatches through both packages' meshes of 2 (the
    port's on two CPU shards): the same per-shard rows and skews."""
    from gome_tpu.engine import BatchEngine as JBatch
    from gome_tpu.engine import BookConfig as JConfig
    from gome_tpu.parallel import make_mesh as jmesh
    from gome_tpu_torch.engine import BatchEngine, BookConfig
    from gome_tpu_torch.parallel import make_mesh

    j = JBatch(JConfig(cap=8, max_fills=4), n_slots=64, max_t=4,
               mesh=jmesh(2))
    t = BatchEngine(BookConfig(cap=8, max_fills=4), n_slots=64, max_t=4,
                    mesh=make_mesh(2, devices=[torch.device("cpu")] * 2))
    jprofiler.PROFILER.install(keep_n=2)
    tprofiler.PROFILER.install(keep_n=2)
    rng = np.random.default_rng(5)
    lives = [np.array([0, 1, 2, 35])] + [
        np.unique(rng.integers(0, 64, int(n))) for n in (3, 9, 20, 30)]
    for live in lives:
        got = t._grid_geometry(live.astype(np.int64))
        want = j._grid_geometry(live.astype(np.int64))
        assert got[:2] == want[:2]
    rep = tprofiler.PROFILER.shard_report()
    assert rep == jprofiler.PROFILER.shard_report()
    assert rep["dispatches"] == len(lives)
    first = tprofiler.PROFILER._shards[0]
    assert first == (2, 8, (3, 1))
