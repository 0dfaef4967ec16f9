"""Measured roofline: a profiler capture window + trace-event attribution.

The port of ``gome_tpu/obs/profiler.py``, on ``torch.profiler`` where the
reference uses ``jax.profiler``:

  * ``capture()`` — a bounded ``torch.profiler.profile`` window (CPU
    activity, plus CUDA activity on the card) whose Chrome trace lands
    gzipped under ``<log_dir>/plugins/profile/<stamp>/``, where
    ``latest_run_dir`` / ``perfetto_path`` / ``load_trace_events`` find
    it, as they find the reference's.
  * ``parse_trace_events()`` — a pure parser. Each measured region is a
    ``record_function`` window named ``gome_profile/<entry>``; device time
    is the **interval union** of the compute events clipped to the
    windows. The reference's rules hold unchanged for events without a
    ``cat`` (its golden traces); torch's events carry one: on the card
    ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events are device time,
    in a trace without them (the CPU) ``cpu_op`` events are. The capture
    sees every thread of the process, and a service's consumer launches
    kernels of its own while a capture runs, so a torch event counts for
    a window only when it is the window's own: given ``streams`` (the
    device streams the measured work ran on), a device event by its
    stream; otherwise a kernel by the thread of its launch record
    (``correlation`` id to the CUDA runtime call; by its stream when no
    record exists), a ``cpu_op`` by its own thread. Kineto can file a
    runtime call under another thread's id (seen on the H100 for every
    capture after the first that starts on a new thread), so
    ``measured_entry_report`` runs its entries on a stream of its own,
    marks that stream with a ``STREAM_MARKER`` kernel, and counts by
    stream.
  * ``measured_entry_report()`` — runs the cost model's entries
    (``costmodel.canonical_entries``) on fresh argument copies inside a
    capture, each call synchronised, on a CUDA stream of its own on the
    card, and joins measured device time with the analytic rows:
    achieved GFLOP/s (integer operations), achieved GB/s, efficiency
    against ``min(peak_flops, intensity * peak_bw)`` (peaks from
    ``GOME_PEAK_GFLOPS`` / ``GOME_PEAK_GBPS`` or a one-shot calibration on
    the entry's device). ``device_time_source`` names what was counted:
    ``cuda_kernels``, ``cpu_ops``, or ``annotation_wall`` when nothing was.

``PROFILER`` is the process singleton behind the ops ``/profile`` endpoint
and the ``gome_profile_*`` gauges, armed from ``ops.profile`` /
``ops.profile_keep`` (service.app). Disabled (the default) its
``note_shard_dispatch`` hook — called from ``engine.batch._grid_geometry``
on every dense mesh dispatch — costs one attribute check and zero
allocations.

Import discipline: no torch at module scope (``engine.batch`` imports
``PROFILER``; the parser stays usable without it).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import threading
import time
from collections import deque

from ..utils.metrics import REGISTRY

#: Annotation-window name prefix (the reference's, ``/`` as separator).
ANNOTATION_PREFIX = "gome_profile/"

#: Host-side event-name prefixes that are runtime plumbing, not compute
#: (the reference's rule for events without a ``cat``).
_HOST_INFRA_PREFIXES = (
    "PjitFunction",
    "ParseArguments",
    "CopyToDevice",
    "TransferTo",
    "BufferFromHost",
    "ExecuteOptions",
    "RunBackend",
)

#: torch trace-event categories that are device time.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host-side CUDA calls whose ``correlation`` ids name a device event's
#: launching thread.
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The kernel ``torch.cuda._sleep`` launches: a capture's first and last
#: launch on its own stream, which names that stream in the trace.
STREAM_MARKER = "spin_kernel"
#: Synchronised launches in a capture's warm-up step (not recorded).
WARMUP_LAUNCHES = 8


# ---------------------------------------------------------------------------
# capture window + artifact plumbing


class Capture:
    """Handle yielded by ``capture()``: where the trace landed."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.run_dir: str | None = None
        self.perfetto: str | None = None


@contextlib.contextmanager
def capture(log_dir: str | None = None, device=None):
    """Bounded profiler window: everything run inside the ``with`` lands
    in one gzipped Chrome trace under ``log_dir`` (a fresh temp dir when
    None); CUDA activity is traced when ``device`` (default: the CUDA
    card) is a card. On exit the handle's ``run_dir``/``perfetto`` point
    at the capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..engine.book import resolve_device

    dev = resolve_device(device)
    cap = Capture(log_dir or tempfile.mkdtemp(prefix="gome-profile-"))
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S") + f".{time.time_ns() % 10**9:09d}"
    run_dir = os.path.join(cap.log_dir, "plugins", "profile", stamp)

    def export(prof) -> None:
        os.makedirs(run_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(run_dir, "gome.perfetto_trace.json.gz"))

    # One warm-up step before the recorded one: on a busy card CUPTI lost
    # the first device events of a capture opened cold (H100, a serving
    # consumer launching meanwhile); the warm-up's launches absorb that.
    with profile(activities=acts, on_trace_ready=export,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if dev.type == "cuda":
            for _ in range(WARMUP_LAUNCHES):
                torch.cuda._sleep(1)
                torch.cuda.current_stream(dev).synchronize()
        prof.step()
        yield cap
        prof.step()
    cap.run_dir = latest_run_dir(cap.log_dir)
    cap.perfetto = perfetto_path(cap.run_dir)


def latest_run_dir(log_dir: str | None) -> str | None:
    """The newest profiler run directory under ``log_dir``
    (``plugins/profile/<stamp>/``), or None."""
    if not log_dir:
        return None
    runs = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*")))
    return runs[-1] if runs else None


def perfetto_path(run_dir: str | None) -> str | None:
    """The gzipped trace inside a run dir, or None."""
    if not run_dir:
        return None
    hits = sorted(glob.glob(os.path.join(run_dir, "*perfetto_trace.json.gz")))
    return hits[-1] if hits else None


def load_trace_events(run_dir: str | None) -> list[dict]:
    """Trace-event list out of a run dir's trace ([] when the capture
    produced nothing)."""
    path = perfetto_path(run_dir)
    if path is None:
        return []
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        return doc.get("traceEvents", []) or []
    return doc or []


# ---------------------------------------------------------------------------
# pure trace-event parser


def _merge(intervals):
    """Sorted, non-overlapping union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(intervals, windows):
    """Intersect op intervals with the (merged) annotation windows."""
    clipped = []
    for s, e in intervals:
        for ws, we in windows:
            cs, ce = max(s, ws), min(e, we)
            if ce > cs:
                clipped.append((cs, ce))
    return clipped


def _union_us(intervals) -> float:
    return sum(e - s for s, e in _merge(intervals))


def _is_compute_op(name: str) -> bool:
    """The reference's host heuristic for events without a ``cat``: XLA
    op names vs runtime plumbing (``$``-prefixed Python events, ``::``
    C++ symbols, the infra prefixes)."""
    if not name or name.startswith("$") or "::" in name:
        return False
    return not name.startswith(_HOST_INFRA_PREFIXES)


def _collect(events, labels, prefix):
    """One pass over the events: per-label windows (with the thread each
    was opened on) and the compute events, each with the (pid, tid, ts) of
    its launch for torch events (None for the reference's; "stream" for a
    device event with no launch record) and its device stream."""
    procs: dict = {}
    plabels: dict = {}
    launches: dict = {}
    has_kernels = False
    for e in events:
        ph, cat = e.get("ph"), e.get("cat")
        if ph == "M" and e.get("name") == "process_name":
            procs[e.get("pid")] = (e.get("args") or {}).get("name", "")
        elif ph == "M" and e.get("name") == "process_labels":
            plabels[e.get("pid")] = (e.get("args") or {}).get("labels", "")
        elif ph == "X" and cat in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("pid"), e.get("tid"),
                                  float(e.get("ts", 0.0)))
        elif ph == "X" and cat in DEVICE_CATS:
            has_kernels = True

    want = {}
    for lab in labels:
        want[prefix + lab] = lab
        want.setdefault(lab, lab)

    windows: dict[str, list] = {lab: [] for lab in labels}
    threads: dict[str, list] = {lab: [] for lab in labels}
    ops = []  # (start, end, name, proc, launch, device stream)
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        cat = e.get("cat")
        try:
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        if name in want and cat != "gpu_user_annotation":
            windows[want[name]].append((ts, ts + dur))
            threads[want[name]].append(
                (e.get("pid"), e.get("tid"), ts, ts + dur))
            continue
        if dur <= 0:
            continue
        pname = procs.get(e.get("pid"), "")
        launch = stream = None
        if cat is None:
            if not ("/device:" in pname or _is_compute_op(name)):
                continue
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            stream = (e.get("pid"), e.get("tid"))
            # No launch record: known only by its stream (_hits).
            launch = launches.get(corr, "stream")
            pname = plabels.get(e.get("pid")) or pname
        elif cat == "cpu_op" and not has_kernels:
            launch = (e.get("pid"), e.get("tid"), ts)
            pname = plabels.get(e.get("pid")) or pname
        else:
            continue
        ops.append((ts, ts + dur, name, pname or "host", launch, stream))
    return windows, threads, ops


def _launched_inside(launch, threads) -> bool:
    pid, tid, ts = launch
    return any(pid == p and tid == t and ws <= ts <= we
               for p, t, ws, we in threads)


def _hits(ops, win, threads, streams=None):
    """(clipped interval, name, proc) of each compute event counted for
    one label's merged windows. With ``streams``, a device event counts
    when it ran on one of them. Without, a device event with no launch
    record counts when it ran on a stream that the window's own launches
    used."""
    own_streams = {
        stream for *_, launch, stream in ops
        if stream is not None and launch != "stream"
        and _launched_inside(launch, threads)
    } if streams is None else set(map(tuple, streams))
    for s, e, name, pname, launch, stream in ops:
        by_stream = streams is not None or launch == "stream"
        if stream is not None and by_stream:
            if stream not in own_streams:
                continue
        elif launch is not None and not _launched_inside(launch, threads):
            continue
        clipped = _clip([(s, e)], win)
        if clipped:
            yield clipped, name, pname


def parse_trace_events(
    events: list[dict],
    labels,
    prefix: str = ANNOTATION_PREFIX,
    streams=None,
) -> dict[str, dict]:
    """Attribute device time to annotation windows.

    For each label, finds its ``prefix + label`` complete events ("X"
    phase; the bare label is accepted too) and computes:

      * ``windows``   — number of annotation windows seen
      * ``wall_us``   — summed window duration
      * ``device_us`` — interval-UNION of compute events clipped to the
        windows (nesting- and thread-duplication-safe)
      * ``by_device`` — the same union split per process (a torch event's
        process label, ``GPU 0`` / ``CPU``, where the trace gives one)
      * ``events``    — number of compute events that intersected
      * ``top_op``    — the single longest contributing event name

    Compute events: the reference's rules for events without a ``cat``
    (a ``/device:`` process, or a host name passing ``_is_compute_op``);
    torch's device categories; torch's ``cpu_op`` events in a trace with
    no device events. A torch event counts only when it is the window's
    own: with ``streams`` ((pid, tid) pairs, see ``marker_streams``) a
    device event on one of them, else one launched from the window's
    thread inside the window (see the module docstring).
    """
    windows, threads, ops = _collect(events, labels, prefix)
    out: dict[str, dict] = {}
    for lab in labels:
        win = _merge(windows[lab])
        if not win:
            out[lab] = {
                "windows": 0, "wall_us": 0.0, "device_us": 0.0,
                "by_device": {}, "events": 0, "top_op": None,
            }
            continue
        hits = []
        by_dev: dict[str, list] = {}
        top_name, top_dur = None, 0.0
        for clipped, name, pname in _hits(ops, win, threads[lab], streams):
            hits.extend(clipped)
            by_dev.setdefault(pname, []).extend(clipped)
            got = sum(ce - cs for cs, ce in clipped)
            if got > top_dur:
                top_name, top_dur = name, got
        out[lab] = {
            "windows": len(windows[lab]),
            "wall_us": round(sum(e - s for s, e in win), 3),
            "device_us": round(_union_us(hits), 3),
            "by_device": {
                d: round(_union_us(iv), 3) for d, iv in sorted(by_dev.items())
            },
            "events": len(hits),
            "top_op": top_name,
        }
    return out


def window_event_names(events: list[dict], label: str,
                       prefix: str = ANNOTATION_PREFIX,
                       streams=None) -> list[str]:
    """The names of the compute events ``parse_trace_events`` counts for
    ``label``, one per event (which kernels a window's device time is)."""
    windows, threads, ops = _collect(events, [label], prefix)
    win = _merge(windows[label])
    return [name for _, name, _ in _hits(ops, win, threads[label], streams)]


def marker_streams(events: list[dict]) -> list[tuple]:
    """The (pid, tid) device streams that ran a ``STREAM_MARKER`` kernel."""
    return sorted({(e.get("pid"), e.get("tid")) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel"
                   and STREAM_MARKER in e.get("name", "")})


# ---------------------------------------------------------------------------
# machine peaks (roofline ceilings)

_PEAKS_CACHE: dict = {}
_PEAKS_LOCK = threading.Lock()


def machine_peaks(refresh: bool = False, device=None) -> dict:
    """Roofline ceilings for ``device`` (default: the CUDA card).
    ``GOME_PEAK_GFLOPS`` / ``GOME_PEAK_GBPS`` override (source ``env``);
    otherwise a one-shot memoized calibration (source ``calibrated``):
    the best of 5 float32 512^3 matmuls (TF32 as torch has it: off by
    default) for the FLOP/s ceiling, the best of 5 elementwise passes over 4M float32 lanes (one
    read and one write stream) for the bandwidth ceiling — practically
    achievable ceilings, not data-sheet numbers. On the card it runs on a
    CUDA stream of its own; other work on the card in the same window
    (a serving consumer) still shares the SMs and lowers them."""
    from ..engine.book import resolve_device

    dev = resolve_device(device)
    key = dev.type
    with _PEAKS_LOCK:
        if key in _PEAKS_CACHE and not refresh:
            return dict(_PEAKS_CACHE[key])
        env_f = os.environ.get("GOME_PEAK_GFLOPS")
        env_b = os.environ.get("GOME_PEAK_GBPS")
        if env_f and env_b:
            peaks = {
                "peak_gflops": float(env_f),
                "peak_gbps": float(env_b),
                "source": "env",
            }
        else:
            peaks = _calibrate(dev)
            if env_f:
                peaks["peak_gflops"] = float(env_f)
            if env_b:
                peaks["peak_gbps"] = float(env_b)
            if env_f or env_b:
                peaks["source"] = "env+calibrated"
        _PEAKS_CACHE[key] = peaks
        return dict(peaks)


def _calibrate(device) -> dict:
    import torch

    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        n = 512
        a = torch.ones((n, n), dtype=torch.float32, device=device)
        best = min(_timed(lambda: a @ a, device) for _ in range(5))
        peak_gflops = 2.0 * n**3 / best / 1e9

        m = 1 << 22  # 4M f32 lanes: 16 MB operand
        v = torch.ones((m,), dtype=torch.float32, device=device)
        best = min(_timed(lambda: v + 1.0, device) for _ in range(5))
        peak_gbps = 2.0 * 4 * m / best / 1e9  # one read + one write stream

    return {
        "peak_gflops": round(peak_gflops, 3),
        "peak_gbps": round(peak_gbps, 3),
        "source": "calibrated",
        "tf32": bool(device.type == "cuda"
                     and torch.backends.cuda.matmul.allow_tf32),
    }


def _timed(fn, device) -> float:
    """Seconds of one call of ``fn`` after a warm call: CUDA events on the
    card, the host clock on the CPU."""
    import torch

    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.current_stream(device).synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return max(start.elapsed_time(end) / 1e3, 1e-9)
    t0 = time.perf_counter()
    fn()
    return max(time.perf_counter() - t0, 1e-9)


# ---------------------------------------------------------------------------
# the measured roofline report


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measured_entry_report(
    dtype: str = "int32", repeats: int = 8, log_dir: str | None = None,
    device=None,
) -> dict:
    """Measure the cost model's entries on ``device`` (default: the CUDA
    card) and join against the analytic rows. Each entry runs once on its
    own arguments OUTSIDE the capture (warm), then ``repeats``
    synchronised calls on fresh argument copies (built before the capture
    opens: compact_accum appends in place) inside one
    ``gome_profile/<entry>`` window; the window's device-time union over
    ``repeats`` is the per-call device time. On the card every call runs
    on a CUDA stream of its own, named in the trace by a STREAM_MARKER
    kernel, and only that stream's device events count (``streams`` in
    the report). Achieved rates divide the ANALYTIC operations and bytes
    by the MEASURED time."""
    import torch
    from torch.profiler import record_function

    from ..engine.book import resolve_device
    from . import costmodel

    dev = resolve_device(device)
    analytic = {
        r["entry"]: r
        for r in costmodel.entry_report(dtype, dev) if "error" not in r
    }
    peaks = machine_peaks(device=dev)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    ctx = torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()
    jobs = []
    with ctx:
        for rec in costmodel.canonical_entries(dtype, dev):
            if rec["entry"] not in costmodel.RATCHET_ENTRIES:
                continue
            arg_sets = [rec["args"]() for _ in range(repeats + 1)]
            try:
                costmodel.run_entry(rec, arg_sets[0])
                _sync(dev)
            except Exception:  # a device that cannot run the entry
                continue
            jobs.append((rec, arg_sets[1:]))
        _sync(dev)
        with capture(log_dir, dev) as cap:
            if stream is not None:
                torch.cuda._sleep(1)  # STREAM_MARKER: names the stream
            for rec, arg_sets in jobs:
                with record_function(ANNOTATION_PREFIX + rec["entry"]):
                    for args in arg_sets:
                        costmodel.run_entry(rec, args)
                        _sync(dev)
            if stream is not None:
                torch.cuda._sleep(1)
                _sync(dev)

    labels = [rec["entry"] for rec, _ in jobs]
    events = load_trace_events(cap.run_dir)
    streams = marker_streams(events) if stream is not None else None
    parsed = parse_trace_events(events, labels, streams=streams)
    source = "cuda_kernels" if dev.type == "cuda" else "cpu_ops"
    entries = {
        label: _roofline_row(label, parsed.get(label),
                             analytic.get(label, {}), repeats, peaks, source)
        for label in labels
    }
    return {
        "dtype": dtype,
        "repeats": repeats,
        "platform": dev.type,
        "device": str(dev),
        "peaks": peaks,
        "entries": entries,
        "streams": streams,
        "run_dir": cap.run_dir,
        "perfetto_trace": cap.perfetto,
    }


def _roofline_row(label, parsed, analytic, repeats, peaks,
                  source: str) -> dict:
    if not parsed or not parsed["windows"]:
        return {"entry": label, "error": "no trace window captured"}
    wall_per_call = parsed["wall_us"] / repeats
    device_us = parsed["device_us"]
    dev_per_call = (device_us or parsed["wall_us"]) / repeats
    row = {
        "entry": label,
        "calls": repeats,
        "wall_us_per_call": round(wall_per_call, 3),
        "device_us_per_call": round(dev_per_call, 3),
        "device_time_source": source if device_us else "annotation_wall",
        "trace_events": parsed["events"],
        "top_op": parsed.get("top_op"),
        "by_device": parsed.get("by_device", {}),
        "flops": analytic.get("flops"),
        "bytes_accessed": analytic.get("bytes_accessed"),
        "arithmetic_intensity": analytic.get("arithmetic_intensity"),
    }
    flops, nbytes = row["flops"], row["bytes_accessed"]
    if dev_per_call > 0:
        if flops is not None:
            # operations per µs → G/s is ×1e6 / 1e9
            row["achieved_gflops"] = round(flops / dev_per_call * 1e-3, 6)
        if nbytes is not None:
            row["achieved_gbps"] = round(nbytes / dev_per_call * 1e-3, 6)
    pf, pb = peaks.get("peak_gflops"), peaks.get("peak_gbps")
    ai = row["arithmetic_intensity"]
    if pf and pb and ai is not None:
        ceiling = min(pf, ai * pb)
        row["roofline_ceiling_gflops"] = round(ceiling, 3)
        if row.get("achieved_gflops") is not None and ceiling > 0:
            row["efficiency_pct"] = round(
                100.0 * row["achieved_gflops"] / ceiling, 4
            )
    return row


def bench_measured(dtype: str = "int32", repeats: int = 4,
                   device=None) -> dict:
    """The compact measured block a benchmark folds next to its analytic
    block: per-entry device time, achieved GFLOP/s / GB/s, efficiency.
    Goes through PROFILER when armed (the report rides the ring and the
    gauges update); a direct capture otherwise."""
    if PROFILER.enabled:
        rep = PROFILER.capture_report(dtype, repeats=repeats, device=device)
    else:
        rep = measured_entry_report(dtype, repeats=repeats, device=device)
    fields = ("device_us_per_call", "achieved_gflops", "achieved_gbps",
              "efficiency_pct")
    return {
        "dtype": dtype,
        "platform": rep["platform"],
        "peaks": rep["peaks"],
        "entries": {
            k: {f: v.get(f) for f in fields}
            for k, v in rep["entries"].items()
            if "error" not in v
        },
    }


# ---------------------------------------------------------------------------
# the process singleton


def _median(xs):
    if not xs:
        return None
    xs = sorted(xs)
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


class Profiler:
    """Bounded ring of measured-roofline reports + per-shard dispatch
    telemetry behind the ops ``/profile`` endpoint.

    Disabled by default. ``install()`` (service.app, from the
    ``ops.profile`` knob) arms the ring and registers the
    ``gome_profile_*`` gauges; per-entry labeled children appear after
    the first capture. ``note_shard_dispatch`` is the hot-path hook —
    engine.batch calls it on every dense mesh dispatch with values it
    already computed, so the disabled cost is ONE attribute check and
    zero allocations."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._reports: deque | None = None  # guarded by self._lock (armed ⇔ deque)
        self._shards: deque | None = None  # guarded by self._lock
        self._log_dir: str | None = None  # guarded by self._lock
        self._captures = 0  # guarded by self._lock

    @property
    def enabled(self) -> bool:
        return self._reports is not None  # gomelint: disable=GL402

    def install(
        self,
        keep_n: int = 8,
        log_dir: str | None = None,
        registry=None,
    ) -> "Profiler":
        with self._lock:
            keep = deque(self._reports or (), maxlen=max(1, int(keep_n)))
            self._reports = keep
            if self._shards is None:
                self._shards = deque(maxlen=256)
            self._log_dir = log_dir
        self._export(registry or REGISTRY)
        return self

    def disable(self) -> None:
        with self._lock:
            self._reports = None
            self._shards = None

    # ------------------------------------------------------------------
    # hot path

    def note_shard_dispatch(self, n_shards, rows_per_shard, live_counts):
        """Record one dense mesh dispatch's per-shard geometry: shard
        count, per-shard row-block height (the bucketed max), and the
        per-shard LIVE lane counts (``np.bincount`` the caller already
        holds). Disabled: one attribute check, zero allocations."""
        shards = self._shards  # gomelint: disable=GL402 — lock-free fast
        if shards is None:  # check; the locked append below re-validates
            return
        with self._lock:
            if self._shards is not None:
                self._shards.append((
                    int(n_shards),
                    int(rows_per_shard),
                    tuple(int(c) for c in live_counts),
                ))

    # ------------------------------------------------------------------
    # reports

    def shard_report(self) -> dict:
        """Aggregate view of the recent dense mesh dispatches: per-shard
        dispatched rows vs live lanes and the skew ratio
        (max-shard-live / mean-shard-live — 1.0 is perfectly balanced)."""
        with self._lock:
            if self._shards is None:
                return {"enabled": False}
            items = list(self._shards)
        if not items:
            return {"enabled": True, "dispatches": 0}
        skews, rows_pll = [], []
        for d, r_s, counts in items:
            live = sum(counts)
            if live:
                skews.append(max(counts) * d / live)
                rows_pll.append(r_s * d / live)
        d, r_s, counts = items[-1]
        live = sum(counts) or 1
        return {
            "enabled": True,
            "dispatches": len(items),
            "last": {
                "n_shards": d,
                "rows_per_shard": r_s,
                "dispatched_rows": d * r_s,
                "live_per_shard": list(counts),
                "skew": round(max(counts) * d / live, 4),
                "rows_per_live_lane": round(d * r_s / live, 4),
            },
            "skew_p50": round(_median(skews), 4) if skews else None,
            "rows_per_live_lane_p50": (
                round(_median(rows_pll), 4) if rows_pll else None
            ),
        }

    def capture_report(self, dtype: str = "int32", repeats: int = 8,
                       device=None) -> dict:
        """Run a measured-roofline capture now on ``device``, push it onto
        the ring, and (re)bind the per-entry gauges. Seconds of work —
        ops surface, never the dispatch path."""
        with self._lock:
            log_dir = self._log_dir
        rep = measured_entry_report(dtype, repeats=repeats, log_dir=log_dir,
                                    device=device)
        with self._lock:
            if self._reports is not None:
                self._reports.append(rep)
                self._captures += 1
        self._export_entries(rep)
        return rep

    def last_report(self) -> dict | None:
        with self._lock:
            if not self._reports:
                return None
            return self._reports[-1]

    def payload(
        self, dtype: str = "int32", refresh: bool = False, repeats: int = 4,
        device=None,
    ) -> dict:
        """The ops ``/profile`` JSON body. Armed with no capture yet (or
        ``?refresh=1``) it captures on demand; the errors a capture can
        hit degrade to an ``error`` field, never a 500."""
        if not self.enabled:
            return {
                "enabled": False, "captures": 0, "report": None,
                "shards": {"enabled": False},
            }
        rep = None if refresh else self.last_report()
        err = None
        if rep is None:
            try:
                rep = self.capture_report(dtype, repeats=repeats,
                                          device=device)
            except Exception as exc:
                err = f"{type(exc).__name__}: {exc}"
        with self._lock:
            n = self._captures
        out = {"enabled": True, "captures": n, "report": rep,
               "shards": self.shard_report()}
        if err:
            out["error"] = err
        return out

    # ------------------------------------------------------------------
    # gauges

    def _export(self, reg) -> None:
        reg.callback_gauge(
            "gome_profile_captures_total",
            "Measured-roofline captures taken since arm",
            lambda: self._captures,  # gomelint: disable=GL402 — see _export
        )
        reg.callback_gauge(
            "gome_profile_shard_skew",
            "p50 max/mean live-lanes-per-shard over recent dense mesh "
            "dispatches (1.0 = balanced)",
            lambda: self.shard_report().get("skew_p50") or 0.0,
        )
        reg.callback_gauge(
            "gome_profile_shard_rows_per_live_lane",
            "p50 dispatched-rows per live lane over recent dense mesh "
            "dispatches (ROADMAP open item 2 targets <= 2.0)",
            lambda: self.shard_report().get("rows_per_live_lane_p50") or 0.0,
        )
        self._registry = reg  # single-writer: install() caller

    def _export_entries(self, rep: dict) -> None:
        reg = getattr(self, "_registry", None)
        if reg is None:
            return
        specs = (
            ("gome_profile_device_us",
             "Measured per-call device time (us) from the last capture",
             "device_us_per_call"),
            ("gome_profile_achieved_gflops",
             "Achieved GFLOP/s (analytic flops / measured device time)",
             "achieved_gflops"),
            ("gome_profile_achieved_gbps",
             "Achieved GB/s (analytic bytes / measured device time)",
             "achieved_gbps"),
            ("gome_profile_efficiency_pct",
             "Achieved GFLOP/s as % of the roofline ceiling",
             "efficiency_pct"),
        )
        for entry, row in rep.get("entries", {}).items():
            if "error" in row:
                continue
            for name, help_, field in specs:
                reg.callback_gauge(
                    name, help_,
                    lambda e=entry, f=field: self._entry_field(e, f),
                    labels={"entry": entry},
                )

    def _entry_field(self, entry: str, field: str) -> float:
        rep = self.last_report()
        if not rep:
            return 0.0
        v = (rep.get("entries", {}).get(entry) or {}).get(field)
        return float(v) if v is not None else 0.0


PROFILER = Profiler()
