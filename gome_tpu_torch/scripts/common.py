"""What the drivers under gome_tpu_torch/scripts and chip_smoke.py share:
the card and run provenance an artifact records, the device rule, and
bench.py's service-bench pieces on the port's side (the mixed flow, the
gateway's per-frame step, the warm-up)."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def require_device(device: str | None) -> str:
    """A driver's device: the CUDA card unless the caller names "cpu";
    raises when the card is asked for and there is none (no fallback)."""
    import torch

    device = device or "cuda"
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "this driver runs on a CUDA card and torch.cuda.is_available() "
            "is False; pass --device cpu to run it on the CPU")
    return device


def commit() -> str | None:
    """The commit the run came from: $GOME_COMMIT when set (a copy of the
    tree has no .git), else git's HEAD, else None."""
    if os.environ.get("GOME_COMMIT"):
        return os.environ["GOME_COMMIT"]
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO, check=True,
            capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def provenance(device: str, argv=None) -> dict:
    """What an artifact records of its run: the card (nvidia-smi's name
    and power limit; None on the CPU), the commit and the command line."""
    argv = sys.argv if argv is None else argv
    import torch

    return {
        "card": card_line() if device != "cpu" else None,
        "device": device,
        "torch": torch.__version__,
        "numpy": np.__version__,
        "commit": commit(),
        "command": " ".join(["python", "-m", _module_of(argv[0]),
                             *argv[1:]]) if argv else None,
    }


def _module_of(path: str) -> str:
    name = os.path.splitext(os.path.basename(path))[0]
    return f"gome_tpu_torch.scripts.{name}"


def expected_launches(engine) -> int:
    """K1 launches an engine's device calls make: one per shard this
    process holds for each grid step (one shard without a mesh), one for
    each per-row fill-record re-run."""
    st, mesh = engine.stats, engine.batch.mesh
    per_row = st.fill_record_escalations
    return (len(mesh.local) if mesh else 1) * (st.device_calls - per_row) \
        + per_row


def host_line() -> str:
    """How the native host library was had: g++'s seconds, or cached."""
    from ..native import build

    secs = build.build_seconds
    return (f"g++ build {secs:.2f} s" if secs is not None
            else "cached g++ build")


def tail_of(f) -> str:
    """The last 2,000 characters a worker wrote to its stderr file."""
    f.flush()
    f.seek(0)
    return f.read()[-2000:]


def wire_request(pb, order):
    """A port Order as the OrderRequest a client sends. fixed.unscale is
    the reference's internal float64 of the scaled integer (what a
    MatchEvent carries); a client sends external units, which the gateway
    scales back to the same ticks: unscale_external."""
    from ..fixed import unscale_external

    return pb.OrderRequest(
        uuid=order.uuid, oid=order.oid, symbol=order.symbol,
        transaction=int(order.side), price=unscale_external(order.price),
        volume=unscale_external(order.volume), kind=int(order.order_type))


def write_json(path: str, doc: dict, sort_keys: bool = True) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=sort_keys)
        f.write("\n")
    os.replace(tmp, path)


def zipf_draws(rng, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 and earlier draw it (numpy's
    random_zipf: U = 1 - u, V = u', X = floor(U ** (-1 / (a - 1))),
    accepted when V * X * (T - 1) / (b - 1) <= T / b), leaving `rng` where
    that draw leaves it. Later numpy draws U as u * Umin + (1 - u), so the
    same seed gives other values: the reference's committed workloads
    (rng 17, zipf(1.2, 1024) % 4096: 411 live lanes) were drawn the old
    way, and this keeps the port's on them under any numpy."""
    am1 = a - 1.0
    b = 2.0 ** am1
    top = float(np.iinfo(np.int64).max)
    state = rng.bit_generator.state
    trials = size + size // 2 + 16
    while True:
        u = rng.random(2 * trials)  # each trial takes exactly two doubles
        rng.bit_generator.state = state
        v = u[1::2]
        # libm's pow, as numpy's C code calls it (numpy's own array power
        # can differ from it in the last bit).
        x = np.floor([_pow(1.0 - w, -1.0 / am1) for w in u[0::2].tolist()])
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.array([_pow(1.0 + 1.0 / w, am1) if w >= 1.0 else 1.0
                          for w in x.tolist()])
            ok = (x <= top) & (x >= 1.0) & (
                v * x * (t - 1.0) / (b - 1.0) <= t / b)
        idx = np.flatnonzero(ok)
        if len(idx) >= size:
            rng.random(2 * (int(idx[size - 1]) + 1))
            return x[idx[:size]].astype(np.int64)
        trials *= 2


def _pow(x: float, y: float) -> float:
    try:
        return math.pow(x, y)
    except OverflowError:
        return math.inf


# -- bench.py's service-bench pieces -----------------------------------------


class MixedFlow:
    """bench.py's _MixedFlow on the port's side: config-5-shaped service
    load, ~45% cancels (a fifth of them targeting ADDs of the same frame,
    some before their ADD: the cancel-before-consume race), ~25% markets
    among ADDs, 256 uuids, Zipf(1) symbols; cancels target really-issued
    (symbol, uuid, oid, price) quadruples from a rolling pool biased to
    the newest quarter. The same rng calls in the same order as
    bench.py's, so a seed gives its frames."""

    CANCEL_P = 0.45
    MARKET_P = 0.25
    SAME_FRAME_P = 0.2
    RECENT_BIAS = 4
    N_UUIDS = 256
    POOL_MAX = 1 << 20

    def __init__(self, rng, n_symbols):
        self.rng = rng
        ranks = np.arange(1, n_symbols + 1, dtype=np.float64)
        w = 1.0 / ranks
        self.sym_p = w / w.sum()
        self.n_symbols = n_symbols
        self.oid0 = 1
        self.pool_sym = np.zeros(self.POOL_MAX, np.uint32)
        self.pool_price = np.zeros(self.POOL_MAX, np.int64)
        self.pool_oid = np.zeros(self.POOL_MAX, np.int64)
        self.pool_uuid = np.zeros(self.POOL_MAX, np.uint32)
        self.pool_n = 0
        self.pool_head = 0

    def _pool_push(self, sym, price, oid, uuid):
        k = len(sym)
        idx = (self.pool_head + np.arange(k)) % self.POOL_MAX
        self.pool_sym[idx] = sym
        self.pool_price[idx] = price
        self.pool_oid[idx] = oid
        self.pool_uuid[idx] = uuid
        self.pool_head = (self.pool_head + k) % self.POOL_MAX
        self.pool_n = min(self.pool_n + k, self.POOL_MAX)

    def frame(self, n):
        rng = self.rng
        action = np.ones(n, np.uint8)
        dels = rng.random(n) < self.CANCEL_P
        if self.pool_n == 0:
            dels[:] = False
        action[dels] = 2
        adds = ~dels
        n_add = int(adds.sum())
        sym = rng.choice(self.n_symbols, size=n, p=self.sym_p).astype(np.uint32)
        price = rng.integers(99_500_000, 100_500_000, n).astype(np.int64)
        volume = rng.integers(1, 101, n).astype(np.int64)
        kind = np.zeros(n, np.uint8)
        mkt = adds & (rng.random(n) < self.MARKET_P)
        kind[mkt] = 1
        oid_nums = np.zeros(n, np.int64)
        oid_nums[adds] = self.oid0 + np.arange(n_add)
        self.oid0 += n_add
        uuid_idx = rng.integers(0, self.N_UUIDS, n).astype(np.uint32)
        di = np.nonzero(dels)[0]
        if len(di):
            same = rng.random(len(di)) < self.SAME_FRAME_P
            ai = np.nonzero(adds & (kind == 0))[0]
            if len(ai) == 0:
                same[:] = False
            n_pool = int((~same).sum())
            if n_pool:
                depth = max(self.pool_n // self.RECENT_BIAS, 1)
                back = rng.integers(1, depth + 1, n_pool)
                pi = (self.pool_head - back) % self.POOL_MAX
                tgt = di[~same]
                sym[tgt] = self.pool_sym[pi]
                price[tgt] = self.pool_price[pi]
                oid_nums[tgt] = self.pool_oid[pi]
                uuid_idx[tgt] = self.pool_uuid[pi]
            if same.any():
                ti = rng.integers(0, len(ai), int(same.sum()))
                src = ai[ti]
                tgt = di[same]
                sym[tgt] = sym[src]
                price[tgt] = price[src]
                oid_nums[tgt] = oid_nums[src]
                uuid_idx[tgt] = uuid_idx[src]
        rest = adds & (kind == 0)
        self._pool_push(sym[rest], price[rest], oid_nums[rest],
                        uuid_idx[rest])
        return dict(
            n=n, action=action, side=rng.integers(0, 2, n).astype(np.uint8),
            kind=kind, price=np.where(mkt, 0, price), volume=volume,
            symbol_idx=sym, uuid_idx=uuid_idx,
            oids=np.char.add("o", oid_nums.astype("U12")).astype("S"))


MIXED_UUIDS = [f"u{i}" for i in range(MixedFlow.N_UUIDS)]


def encode_frame(cols) -> bytes:
    """A decoded ORDER frame's columns back to its wire bytes."""
    from ..bus.colwire import encode_order_frame

    return encode_order_frame(
        cols["n"], cols["action"], cols["side"], cols["kind"], cols["price"],
        cols["volume"], cols["symbols"], cols["symbol_idx"], cols["uuids"],
        cols["uuid_idx"], cols["oids"])


def gateway_step(engine, queue, cols) -> None:
    """The gateway's per-frame work (bench.py's _svc_gateway_step): encode
    the ORDER frame, mark its ADDs in the pre-pool, publish to doOrder.
    `engine` is anything with mark_frame (a MatchEngine or a pre-pool)."""
    payload = encode_frame(cols)
    engine.mark_frame(cols)
    queue.publish(payload)


def svc_warmup(engine, consumer, bus, make_frame, margin: bool = True) -> int:
    """bench.py's _svc_warmup on the port: drain warm frames until the
    geometry ratchets hold still for two frames (8 to 12); with `margin`,
    forget the transient's floors and combos, two steady frames, pin the
    rows/depth/cancels floors at 2x, one more frame. Returns the warm
    frames consumed."""
    q = bus.order_queue
    n_warm = stable = 0
    while n_warm < 8 or stable < 2:
        if n_warm >= 12:
            break
        geo = engine.batch.geometry_floors()
        gateway_step(engine, q, make_frame())
        consumer.drain()
        stable = stable + 1 if engine.batch.geometry_floors() == geo else 0
        n_warm += 1
    if not margin:
        return n_warm
    engine.batch.reset_geometry_floors(combos=True)
    for _ in range(2):
        gateway_step(engine, q, make_frame())
        consumer.drain()
        n_warm += 1
    g = engine.batch.geometry_floors()
    engine.batch.prewarm_geometry(
        rows_floor={c: 2 * v for c, v in g["rows_floor"].items()},
        t_floor={c: 2 * v for c, v in g["t_floor"].items()},
        cancels_buf={b: 2 * v for b, v in g["cancels_buf"].items()},
    )
    gateway_step(engine, q, make_frame())
    consumer.drain()
    return n_warm + 1
