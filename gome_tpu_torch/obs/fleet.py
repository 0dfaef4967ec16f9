"""Fleet observability — metric federation + cross-process trace stitching.

The port of ``gome_tpu/obs/fleet.py`` (stdlib HTTP only; no torch). Every
other observability surface is process-local: one registry, one flight
recorder, one timeline ring, one health monitor. This module serves the
N-gateway x M-consumer view:

  * **Metric federation** — :class:`FleetAggregator` polls N member
    processes' ops endpoints (``/metrics``, ``/healthz``, ``/timeline``,
    ``/durability``, ``/placement``) and serves ONE merged view from its
    own ops server (``/fleet``). The exposition merge lives in
    ``utils.metrics`` (``parse_exposition``/``merge_expositions``):
    counters SUM, same-bucket histograms merge, gauges union under a new
    ``proc`` label — lossless (per-family totals equal the sum of the
    members).

  * **Trace stitching** — :func:`stitch_journeys` joins flight-recorder
    exports (``FlightRecorder.export``) by trace id across process
    boundaries. The gateway process records ``ingress``/``enqueue`` and
    never sees the consumer-side ``complete()``; the consumer process
    records ``bus_transit`` onward. Each process timestamps with its OWN
    ``time.perf_counter`` epoch, so the halves live on unrelated clocks:
    the ``"<id>@<t>"`` wire context gives every ``bus_transit`` span a
    sender-clock t0 and a receiver-clock t1, and the MINIMUM observed
    (t1 - t0) over all joined traces estimates the receiver-vs-sender
    clock offset (the fastest hop bounds transit from above, as NTP's
    minimum-RTT filter does). Receiver spans shift onto the sender clock;
    the stitched journey renders as one Chrome-trace timeline with
    per-process tracks (:func:`stitched_chrome_trace`).

  * **Seq audit** — the ``SeqTracker`` state each member publishes under
    ``/durability`` rolls up fleet-wide: zero dupes + zero gaps across
    every partition is the exactly-once verdict.

  * **Placement rollup** — the members' ``/placement`` Space-Saving
    sketches (``obs.placement.SpaceSaving``'s GSS1 blobs) merge into one
    heavy-hitter table, beside each member's admitted-order share and the
    partition imbalance (max over mean of the members' admits).

Hot-path contract (same as TRACER/JOURNAL/TIMELINE/HOSTPROF/FAULTS): the
module-level ``FLEET`` is DISABLED by default — ``poll()`` degrades to
one attribute check and ZERO allocations. ``install()`` arms it with a
member map; the polling thread runs only between ``start()``/``stop()``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from ..utils.metrics import (
    REGISTRY,
    Registry,
    family_total,
    merge_expositions,
    parse_exposition,
    render_exposition,
)


def _default_fetch(url: str, timeout_s: float) -> str:
    """GET one member endpoint. An HTTP error status still returns the
    body — a 503 /healthz carries the full health JSON and the
    aggregator must see WHY the member is unhealthy, not just that the
    fetch 'failed'."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.read().decode()


# -- trace stitching -------------------------------------------------------


def estimate_offsets(exports: dict[str, dict]) -> dict[tuple, float]:
    """{(sender, receiver): offset_s} — the receiver-clock-minus-sender-
    clock estimate per process pair, from the minimum observed
    ``bus_transit`` delta (t0 is the sender's clock carried in the wire
    context, t1 the receiver's clock at receipt; the fastest hop is the
    tightest upper bound on true transit, so its delta is the best
    offset estimate available without a clock protocol). The sender of
    a trace is the process holding its ``ingress`` span."""
    offsets: dict[tuple, float] = {}
    by_trace = _index_by_trace(exports)
    for procs in by_trace.values():
        sender = _sender_of(procs)
        if sender is None:
            continue
        for proc, j in procs.items():
            if proc == sender:
                continue
            for span in j["spans"]:
                if span[0] == "bus_transit":
                    delta = span[2] - span[1]
                    key = (sender, proc)
                    if key not in offsets or delta < offsets[key]:
                        offsets[key] = delta
    return offsets


def _index_by_trace(exports: dict[str, dict]) -> dict[str, dict[str, dict]]:
    by_trace: dict[str, dict[str, dict]] = {}
    for proc, exp in exports.items():
        if not exp:
            continue
        for j in exp.get("journeys", ()):
            by_trace.setdefault(j["trace_id"], {})[proc] = j
    return by_trace


def _sender_of(procs: dict[str, dict]) -> str | None:
    for proc, j in procs.items():
        if any(span[0] == "ingress" for span in j["spans"]):
            return proc
    return None


def stitch_journeys(exports: dict[str, dict]) -> dict:
    """Join per-process flight-recorder exports into cross-process
    journeys on the SENDER's clock. `exports` maps process name ->
    ``FlightRecorder.export()`` dict (or None for an unreachable
    member). Returns::

        {"journeys": [...], "offsets": {"gw->con": s}, "traces": N,
         "joined": M}

    where each stitched journey carries per-span process attribution::

        {"trace_id", "procs": [...], "sender", "spans":
         [{"proc", "stage", "t0", "t1"}, ...], "start", "end",
         "duration_s"}

    Receiver-process spans shift by -offset onto the sender clock —
    EXCEPT ``bus_transit``, whose t0 is already sender-clock (carried in
    the wire context): only its t1 shifts. Single-process traces are not
    stitched (they are already whole in their member's /trace)."""
    by_trace = _index_by_trace(exports)
    offsets = estimate_offsets(exports)
    journeys = []
    for tid, procs in sorted(by_trace.items()):
        if len(procs) < 2:
            continue
        sender = _sender_of(procs)
        if sender is None:
            continue
        spans = []
        for proc, j in procs.items():
            off = 0.0 if proc == sender else offsets.get((sender, proc))
            if off is None:
                continue  # no bus_transit joined this pair — can't align
            for span in j["spans"]:
                stage, t0, t1 = span[0], span[1], span[2]
                if proc != sender:
                    if stage == "bus_transit":
                        t1 = t1 - off  # t0 already sender-clock
                    else:
                        t0, t1 = t0 - off, t1 - off
                spans.append({"proc": proc, "stage": stage,
                              "t0": t0, "t1": t1})
        if len({s["proc"] for s in spans}) < 2:
            continue
        spans.sort(key=lambda s: s["t0"])
        start = min(s["t0"] for s in spans)
        end = max(s["t1"] for s in spans)
        journeys.append(
            {
                "trace_id": tid,
                "procs": sorted({s["proc"] for s in spans}),
                "sender": sender,
                "spans": spans,
                "start": start,
                "end": end,
                "duration_s": end - start,
            }
        )
    return {
        "journeys": journeys,
        "offsets": {f"{a}->{b}": off for (a, b), off in sorted(offsets.items())},
        "traces": len(by_trace),
        "joined": len(journeys),
    }


def stitched_chrome_trace(stitch: dict) -> dict:
    """A :func:`stitch_journeys` result as Chrome trace-event JSON with
    one pid (track group) per PROCESS — load in Perfetto and the
    gateway's ingress/enqueue sit above the consumer's bus_transit/
    device_execute on one shared (sender-clock) time axis."""
    journeys = stitch.get("journeys", ())
    events: list[dict] = []
    procs: list[str] = []
    for j in journeys:
        for p in j["procs"]:
            if p not in procs:
                procs.append(p)
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    for p in procs:
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid_of[p],
                "tid": 0,
                "args": {"name": p},
            }
        )
    t_min = min((j["start"] for j in journeys), default=0.0)
    for tid_ix, j in enumerate(journeys):
        for span in j["spans"]:
            events.append(
                {
                    "name": span["stage"],
                    "cat": "order",
                    "ph": "X",
                    "pid": pid_of[span["proc"]],
                    "tid": tid_ix,
                    "ts": (span["t0"] - t_min) * 1e6,
                    "dur": max(span["t1"] - span["t0"], 0.0) * 1e6,
                    "args": {"trace_id": j["trace_id"],
                             "proc": span["proc"]},
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- the aggregator --------------------------------------------------------


class FleetAggregator:
    """Polls N member ops endpoints and serves the merged fleet view.

    Disabled by default: ``poll()`` returns None after one attribute
    check (zero allocations — the house singleton contract).
    ``install(members={name: "http://host:port"})`` arms it;
    ``start()`` runs the periodic poller on a daemon thread (``poll()``
    also works on demand — tests and the drill drive it directly)."""

    def __init__(self):
        self.interval_s = 1.0  # single-writer: install() caller
        self.timeout_s = 2.0  # single-writer: install() caller
        self._lock = threading.Lock()
        self._members: dict | None = None  # guarded by self._lock (arm state)
        self._fetch = _default_fetch  # single-writer: install() caller
        self._registry: Registry = REGISTRY  # single-writer: install()/disable() caller
        self._last: dict = {}  # guarded by self._lock — latest member snapshots
        self._last_ok: dict = {}  # guarded by self._lock — per-member last fully-successful poll (clock time)
        self.stale_after_s = 3.0  # single-writer: install() caller
        self._clock = time.monotonic  # single-writer: install() caller
        self._polls = 0  # guarded by self._lock
        self._unhealthy_polls = 0  # guarded by self._lock
        self._degraded_polls = 0  # guarded by self._lock
        self._fetch_errors = 0  # guarded by self._lock
        self._thread: threading.Thread | None = None  # single-writer: start()/stop() caller
        self._stop = threading.Event()

    @property
    def enabled(self) -> bool:
        # Off-lock read is the fast check (same benign-race contract as
        # TimelineSampler.enabled / Tracer.recorder).
        return self._members is not None

    # -- lifecycle ---------------------------------------------------------
    def install(
        self,
        members: dict[str, str],
        interval_s: float = 1.0,
        timeout_s: float = 2.0,
        registry: Registry | None = None,
        fetch=None,
        stale_after_s: float | None = None,
        clock=None,
    ) -> "FleetAggregator":
        """Arm the aggregator over `members` ({name: base URL of that
        process's ops server}). `fetch` is injectable for tests (a
        callable ``(url, timeout_s) -> str``); `registry` receives the
        ``gome_fleet_*`` gauges (process REGISTRY by default).
        `stale_after_s` bounds how old a member's last successful poll
        may be before it is surfaced as STALE/down (default 3x the poll
        interval — one missed sweep is noise, three is an outage);
        `clock` is injectable for the staleness tests."""
        if not members:
            raise ValueError("fleet members must be a non-empty {name: url}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        if stale_after_s is not None and stale_after_s <= 0:
            raise ValueError(
                f"stale_after_s must be positive, got {stale_after_s}"
            )
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.stale_after_s = (
            float(stale_after_s)
            if stale_after_s is not None
            else 3.0 * self.interval_s
        )
        if clock is not None:
            self._clock = clock
        if fetch is not None:
            self._fetch = fetch
        if registry is not None:
            self._registry = registry
        with self._lock:
            self._members = {
                str(k): str(v).rstrip("/") for k, v in members.items()
            }
            self._last = {}
            self._last_ok = {}
            self._polls = 0
            self._unhealthy_polls = 0
            self._degraded_polls = 0
            self._fetch_errors = 0
        self._export(self._registry)
        return self

    def disable(self) -> None:
        """Back to the zero-overhead state: stops the thread, drops the
        member map and snapshots, and re-binds the process REGISTRY (a
        test's private registry must not stick to the singleton)."""
        self.stop()
        with self._lock:
            self._members = None
            self._last = {}
            self._last_ok = {}
            self._polls = 0
            self._unhealthy_polls = 0
            self._degraded_polls = 0
            self._fetch_errors = 0
        self._fetch = _default_fetch
        self._registry = REGISTRY
        self._clock = time.monotonic

    # -- polling -----------------------------------------------------------
    def poll(self) -> dict | None:
        """Scrape every member once; returns {name: member state} or
        None while disabled. Disabled = one attribute check, zero
        allocations (the guarded hot-path contract — an embedding
        service may call this unconditionally)."""
        members = self._members
        if members is None:  # disabled-state contract, re-checked below
            return None
        snap = {name: self._scrape_member(url) for name, url in members.items()}
        n_unhealthy = sum(1 for m in snap.values() if not m["healthy"])
        n_degraded = sum(1 for m in snap.values() if m["degraded"])
        n_errors = sum(1 for m in snap.values() if m["error"] is not None)
        now = self._clock()
        with self._lock:
            if self._members is None:  # disabled between check and lock
                return None
            self._polls += 1
            if n_unhealthy:
                self._unhealthy_polls += 1
            if n_degraded:
                self._degraded_polls += 1
            self._fetch_errors += n_errors
            for name, st in snap.items():
                if st["error"] is None:
                    self._last_ok[name] = now
            self._last = snap
        return snap

    # -- member liveness ---------------------------------------------------
    def poll_age_s(self, name: str) -> float | None:
        """Seconds since `name`'s last fully-successful scrape, or None
        if it has never been scraped successfully."""
        t = self._last_ok.get(name)
        return None if t is None else max(self._clock() - t, 0.0)

    def member_up(self, name: str) -> bool:
        """True while `name`'s latest scrape succeeded AND is fresh
        (poll age within stale_after_s) — the gome_fleet_member_up
        gauge value. An unreachable or stale member reads 0, never a
        silently-served stale merge."""
        st = self._last.get(name)
        if st is None or st["error"] is not None:
            return False
        age = self.poll_age_s(name)
        return age is not None and age <= self.stale_after_s

    def _scrape_member(self, url: str) -> dict:
        """One member's /healthz + /metrics + /durability + /timeline,
        as a state dict. A partially-reachable member keeps whatever
        fetched before the failure; `error` names the first failure."""
        state: dict = {
            "url": url,
            "healthy": False,
            "degraded": False,
            "error": None,
            "health": None,
            "families": None,
            "seq": None,
            "durability": None,
            "timeline": (),
            "placement": None,
        }
        try:
            hz = json.loads(self._fetch(url + "/healthz", self.timeout_s))
            state["health"] = hz
            state["healthy"] = bool(hz.get("healthy"))
            detail = hz.get("detail")
            if isinstance(detail, dict):
                state["degraded"] = bool(detail.get("degraded"))
            state["families"] = parse_exposition(
                self._fetch(url + "/metrics", self.timeout_s)
            )
            dur = json.loads(self._fetch(url + "/durability", self.timeout_s))
            state["durability"] = dur
            state["seq"] = (dur or {}).get("matchfeed")
            tl = json.loads(self._fetch(url + "/timeline", self.timeout_s))
            state["timeline"] = list((tl or {}).get("samples", ()))[-8:]
        except Exception as exc:  # one dead member must not kill the poll
            state["error"] = f"{type(exc).__name__}: {exc}"
        try:
            # Placement scrape rides its own try: a member predating the
            # /placement surface (or running with it off) must not mark
            # the whole member unhealthy — its health/metrics above stay.
            state["placement"] = json.loads(
                self._fetch(url + "/placement", self.timeout_s)
            )
        except Exception:
            state["placement"] = None
        return state

    def start(self) -> "FleetAggregator":
        """Run the periodic poller on a daemon thread (idempotent). The
        cadence is fixed at install() time — one config point keeps
        interval_s genuinely single-writer."""
        if self._members is None:
            # a disable() racing start() is caught by poll()'s own
            # locked re-check (the thread then records nothing)
            raise RuntimeError("install() the aggregator before start()")
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-aggregator", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the poller thread (snapshots survive)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll()
            except Exception:  # a broken member must not kill the thread
                pass

    # -- trace stitching over the fleet ------------------------------------
    def journeys(self) -> dict[str, dict]:
        """{member: FlightRecorder export} fetched from every member's
        ``/trace?format=journeys`` (None for a member whose fetch
        failed); {} while disabled."""
        members = self._members
        if members is None:
            return {}
        out = {}
        for name, url in members.items():
            try:
                out[name] = json.loads(
                    self._fetch(url + "/trace?format=journeys", self.timeout_s)
                )
            except Exception:
                out[name] = None
        return out

    def stitch(self) -> dict:
        """Cross-process journeys joined by trace id, on the sender
        clock (see :func:`stitch_journeys`)."""
        return stitch_journeys(self.journeys())

    # -- views -------------------------------------------------------------
    def rollup(self) -> dict:
        with self._lock:
            members = self._members
            return {
                "members": len(members or ()),
                "polls": self._polls,
                "unhealthy_polls": self._unhealthy_polls,
                "degraded_polls": self._degraded_polls,
                "fetch_errors": self._fetch_errors,
            }

    def payload(self) -> dict:
        """The /fleet wire form. Uses the latest poll's snapshots (one
        synchronous poll happens here if none exist yet); the merge runs
        at read time so /fleet always reflects the newest member
        scrapes. A merge failure (type conflict, bucket mismatch) lands
        as ``metrics.error`` — the health/seq surfaces must survive a
        malformed member exposition."""
        if not self.enabled:
            return {"enabled": False}
        with self._lock:
            snap = dict(self._last)
        if not snap:
            snap = self.poll() or {}
        members_out = {}
        exps: dict[str, dict] = {}
        seq_procs: dict[str, dict] = {}
        timeline: dict[str, list] = {}
        unreachable = []
        for name, st in snap.items():
            up = self.member_up(name)
            age = self.poll_age_s(name)
            stale = age is None or age > self.stale_after_s
            members_out[name] = {
                "url": st["url"],
                "healthy": st["healthy"],
                "degraded": st["degraded"],
                "error": st["error"],
                "health": st["health"],
                "seq": st["seq"],
                "up": up,
                "poll_age_s": age,
                "stale": stale,
            }
            if not up:
                unreachable.append(name)
            if st["families"] is not None:
                exps[name] = st["families"]
            if isinstance(st["seq"], dict):
                seq_procs[name] = st["seq"]
            timeline[name] = list(st["timeline"])
        try:
            merged = merge_expositions(exps) if exps else {}
            metrics = {
                "exposition": render_exposition(merged) if merged else "",
                "families": {
                    n: {"type": f.typ, "total": family_total(f)}
                    for n, f in merged.items()
                },
            }
        except ValueError as exc:
            metrics = {"error": str(exc)}
        fleet_seq = {
            k: sum(int(s.get(k, 0)) for s in seq_procs.values())
            for k in ("observed", "dupes", "gaps")
        }
        return {
            "enabled": True,
            "placement": self._placement_rollup(snap),
            "members": members_out,
            # Members whose latest scrape failed or went stale — callers
            # (and the fleet drill verdict) see explicitly WHOSE data is
            # missing from the merge instead of a silently thinner view.
            "unreachable": sorted(unreachable),
            "stale_after_s": self.stale_after_s,
            "rollup": self.rollup(),
            "metrics": metrics,
            "seq": {"procs": seq_procs, "fleet": fleet_seq},
            "timeline": timeline,
        }

    # -- placement flow rollup ---------------------------------------------
    def _placement_rollup(self, snap: dict) -> dict | None:
        """Fleet-wide symbol-flow view from the members' /placement
        scrapes: per-member admitted-order share (max over mean
        of member order totals) and the merged heavy-hitter table (obs.placement.
        SpaceSaving sketches fold losslessly, so the rollup is exact
        whichever order members merge). None while no member reports an
        armed observatory."""
        from .placement import SpaceSaving

        members: dict[str, dict] = {}
        rollup = None
        for name in sorted(snap):
            pl = snap[name].get("placement")
            if not (isinstance(pl, dict) and pl.get("enabled")):
                continue
            members[name] = {"admits": int(pl.get("admits", 0))}
            blob = (pl.get("sketch") or {}).get("bytes_hex")
            if not blob:
                continue
            try:
                sk = SpaceSaving.from_bytes(bytes.fromhex(blob))
            except ValueError:
                members[name]["sketch_error"] = "undecodable"
                continue
            if rollup is None:
                rollup = sk
            else:
                rollup.merge(sk)
        if not members:
            return None
        total = sum(m["admits"] for m in members.values())
        for m in members.values():
            m["order_share"] = (
                round(m["admits"] / total, 4) if total else 0.0
            )
        return {
            "members": members,
            "partition_imbalance_max_over_mean": self.partition_imbalance(),
            "flow": None if rollup is None else {
                "total": rollup.total,
                "tracked": rollup.tracked,
                "top": rollup.top(16),
            },
        }

    def partition_imbalance(self) -> float:
        """Live partition order imbalance: max over mean of per-member
        admitted-order totals from the latest placement scrapes (1.0 =
        perfectly even). 0.0
        while fewer than one member reports an armed observatory."""
        with self._lock:
            snap = dict(self._last)
        admits = [
            int(st["placement"].get("admits", 0))
            for st in snap.values()
            if isinstance(st.get("placement"), dict)
            and st["placement"].get("enabled")
        ]
        total = sum(admits)
        if not admits or not total:
            return 0.0
        return max(admits) / (total / len(admits))

    # -- metrics export ----------------------------------------------------
    def _export(self, registry: Registry) -> None:
        """Scrape-time ``gome_fleet_*`` gauges on the AGGREGATOR's own
        exposition (they describe the aggregation, so they ride the
        gauge union under ``proc`` if an aggregator is itself a fleet
        member). Off-lock int reads on purpose — a scrape must never
        contend with a poll; stale, never torn."""
        registry.callback_gauge(
            "gome_fleet_members",
            "member processes the fleet aggregator is polling",
            lambda: len(self._members or ()),
        )
        registry.callback_gauge(
            "gome_fleet_polls_total",
            "fleet poll sweeps completed since install",
            lambda: self._polls,
        )
        registry.callback_gauge(
            "gome_fleet_unhealthy_polls_total",
            "poll sweeps that saw >=1 unhealthy member",
            lambda: self._unhealthy_polls,
        )
        registry.callback_gauge(
            "gome_fleet_degraded_polls_total",
            "poll sweeps that saw >=1 degraded member (breaker/spill)",
            lambda: self._degraded_polls,
        )
        registry.callback_gauge(
            "gome_fleet_fetch_errors_total",
            "member endpoint fetches that failed",
            lambda: self._fetch_errors,
        )
        registry.callback_gauge(
            "gome_fleet_partition_imbalance",
            "max/mean of per-member admitted-order totals from the "
            "latest placement scrapes (1.0 = even; 0 = no data)",
            self.partition_imbalance,
        )
        # Per-member liveness: one labeled child per member name (the
        # member set is fixed at install time). 1 = latest scrape
        # succeeded and is fresh; 0 = unreachable or stale.
        for name in (self._members or {}):
            registry.callback_gauge(
                "gome_fleet_member_up",
                "1 while the member's latest poll succeeded and is fresh "
                "(within stale_after_s); 0 = unreachable or stale",
                (lambda n: lambda: float(self.member_up(n)))(name),
                labels={"proc": name},
            )


#: Process-global aggregator (disabled until something installs a member
#: map — service boot wires it from the ``fleet:`` config section).
FLEET = FleetAggregator()
