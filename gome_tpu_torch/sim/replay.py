"""Deterministic seeded replay: manifests, digests, and GCO record mode.

The port of ``gome_tpu/sim/replay.py``. A run manifest is `(seed, config,
n_steps)` plus a canonical-JSON config hash, the same JSON and the same
``config_sha256`` as the reference's, so a manifest written by either
package loads in the other. `run_from_manifest` replays one and folds the
whole trade stream + final book state into a sha256 digest, so two
processes can assert bit-exact equality without shipping trajectories
around.

The draws, and therefore the digest, belong to this package and to the
device type: torch's generators are not ``jax.random``, and a CUDA
generator's bits are not a CPU one's. A CPU run and a CUDA run of one
manifest give different digests, and neither equals ``gome_tpu``'s; two
runs of one manifest on one device type give one digest.

Record mode dumps each step's generated background grid as a GCO ORDER
frame (bus.colwire) — the exact wire form the service path consumes — so a
sim run can be re-fed through gateway -> bus -> consumer for cross-stack
validation. Since each grid column holds at most one event, the occupied
cells in (t, lane) order are the occurring bins in bin order: record mode
builds the columns from the [T] per-bin vectors (``bin_columns``) instead
of fetching the whole [S, T] grid.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from ..engine.book import BookConfig, _host, numpy_dtype, resolve_device
from .env import EnvConfig, _env_step, env_reset, null_action, rollout
from .flow import Bins, FlowConfig

MANIFEST_VERSION = 1


# -- manifest ---------------------------------------------------------------

def config_dict(config: EnvConfig) -> dict:
    """JSON-able canonical form of an EnvConfig (dtype by name)."""
    return {
        "flow": dataclasses.asdict(config.flow),
        "book": {
            "cap": config.book.cap,
            "max_fills": config.book.max_fills,
            "dtype": numpy_dtype(config.book.dtype).name,
        },
        "n_agent_ops": config.n_agent_ops,
        "obs_levels": config.obs_levels,
        "agent_uid": config.agent_uid,
    }


def config_digest(config: EnvConfig) -> str:
    blob = json.dumps(
        config_dict(config), sort_keys=True, separators=(",", ":")
    )
    return hashlib.sha256(blob.encode()).hexdigest()


def make_manifest(config: EnvConfig, seed: int, n_steps: int) -> dict:
    """The (seed, config hash, step count) record that pins one run."""
    return {
        "version": MANIFEST_VERSION,
        "seed": int(seed),
        "n_steps": int(n_steps),
        "config": config_dict(config),
        "config_sha256": config_digest(config),
    }


def env_config_from_manifest(manifest: dict) -> EnvConfig:
    """Rebuild the EnvConfig and verify the manifest's config hash (a
    hand-edited manifest must fail loudly, not replay something else)."""
    if manifest.get("version") != MANIFEST_VERSION:
        raise ValueError(
            f"unsupported sim manifest version {manifest.get('version')!r}"
        )
    c = manifest["config"]
    config = EnvConfig(
        flow=FlowConfig(**c["flow"]),
        book=BookConfig(
            cap=c["book"]["cap"],
            max_fills=c["book"]["max_fills"],
            dtype=c["book"]["dtype"],
        ),
        n_agent_ops=c["n_agent_ops"],
        obs_levels=c["obs_levels"],
        agent_uid=c["agent_uid"],
    )
    digest = config_digest(config)
    if digest != manifest["config_sha256"]:
        raise ValueError(
            f"sim manifest config hash mismatch: manifest says "
            f"{manifest['config_sha256'][:12]}…, config rebuilds to "
            f"{digest[:12]}…"
        )
    return config


def run_from_manifest(manifest: dict, device=None) -> dict:
    """Replay a manifest (background flow only) on ``device`` (default: the
    CUDA card) and digest the result.

    The digest folds the per-step fill-stream checksums (env.StepInfo)
    and every leaf of the final book state — any divergence anywhere in
    the trade sequence or book evolution changes it. One rollout, one
    fetch at the end."""
    config = env_config_from_manifest(manifest)
    state, _ = env_reset(config, manifest["seed"], resolve_device(device))
    final, (_rewards, info) = rollout(config, state, manifest["n_steps"])
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(_host(info.checksum)).tobytes())
    for leaf in final.books:
        h.update(np.ascontiguousarray(_host(leaf)).tobytes())
    return {
        "digest": h.hexdigest(),
        "n_steps": int(manifest["n_steps"]),
        "events": int(info.events.sum()),
        "trades": int(info.trades.sum()),
        "book_overflow": int(info.book_overflow.sum()),
        "fill_overflow": int(info.fill_overflow.sum()),
    }


# -- grid -> host columns / orders ------------------------------------------

def _columns(lane_idx, pick, drop_misses: bool) -> dict:
    """Service-wire columns from the occupied cells' lanes and a field
    reader (`pick(name)` -> that field at the cells, in order)."""
    action = pick("action")
    oid_num = pick("oid").astype(np.int64)
    keep = slice(None)
    if drop_misses:
        keep = ~((action == 2) & (oid_num == 0))
    uid = pick("uid").astype(np.int64)[keep]
    oid_num = oid_num[keep]
    return dict(
        n=len(oid_num),
        action=action[keep].astype(np.uint8),
        side=pick("side")[keep].astype(np.uint8),
        kind=pick("is_market")[keep].astype(np.uint8),
        price=pick("price")[keep].astype(np.int64),
        volume=pick("volume")[keep].astype(np.int64),
        symbol_idx=np.asarray(lane_idx)[keep].astype(np.uint32),
        # Background uids are 1..n_uids -> dictionary indices 0-based.
        uuid_idx=np.maximum(uid - 1, 0).astype(np.uint32),
        oids=np.char.add("o", oid_num.astype("U20")).astype("S"),
    )


def grid_to_columns(ops: dict, drop_misses: bool = False) -> dict:
    """One host-side `[S, T]` op grid (numpy leaves, DeviceOp field names)
    to service-wire columns (the bench/_svc_gateway_step contract).

    Occupied cells are linearized in (t, lane) order — a grid column is
    one arrival instant across lanes, so t-major order is a faithful
    serial stream for the per-lane FIFO semantics. `drop_misses` removes
    deliberate-miss cancels (oid handle 0) for consumers that track oid
    liveness (the service pre-pool)."""
    t_idx, lane_idx = np.nonzero(np.asarray(ops["action"]).T != 0)
    return _columns(lane_idx, lambda f: np.asarray(ops[f])[lane_idx, t_idx],
                    drop_misses)


def bin_columns(bins: Bins, drop_misses: bool = False) -> dict:
    """``grid_to_columns`` of a background grid, from its [T] per-bin
    vectors (flow.Bins, any device): the occurring bins in bin order. One
    fetch of 8 x T values instead of the 7 x S x T grid."""
    stacked = _host(torch.stack([v.to(torch.int64) for v in bins]))
    host = dict(zip(Bins._fields, stacked))
    on = np.nonzero(host["action"] != 0)[0]
    return _columns(host["lane"][on], lambda f: host[f][on], drop_misses)


def orders_from_grid(ops: dict, drop_misses: bool = False) -> list:
    """Host-side grid -> Order objects (for the oracle-parity fuzz
    harness). Symbols are "s{lane}", uuids "u{idx}", oids "o{handle}"."""
    return orders_from_columns(grid_to_columns(ops, drop_misses=drop_misses))


def orders_from_columns(cols: dict) -> list:
    """Service-wire columns (grid_to_columns / bin_columns) -> Order
    objects, named as orders_from_grid names them."""
    from ..types import Action, Order, OrderType, Side

    out = []
    for i in range(cols["n"]):
        out.append(Order(
            uuid=f"u{int(cols['uuid_idx'][i])}",
            oid=cols["oids"][i].decode(),
            symbol=f"s{int(cols['symbol_idx'][i])}",
            side=Side(int(cols["side"][i])),
            price=int(cols["price"][i]),
            volume=int(cols["volume"][i]),
            action=Action(int(cols["action"][i])),
            order_type=OrderType(int(cols["kind"][i])),
        ))
    return out


# -- GCO record mode --------------------------------------------------------

def _record_step(config: EnvConfig, state):
    """One background-only env transition that ALSO returns the generated
    grid, and its ops in bin order (flow.Bins): the very grid the step
    applied. Returns (state', grid, info, bins)."""
    state2, _obs, _reward, info, bg_ops, bins = _env_step(
        config, state, null_action(config, state.cash.device)
    )
    return state2, bg_ops, info, bins


def record_frames(
    config: EnvConfig, seed: int, n_steps: int, device=None
) -> list[bytes]:
    """Replay `n_steps` of background flow on ``device`` (default: the CUDA
    card), dumping each step's grid as one GCO ORDER frame (empty steps are
    skipped). The frames re-feed the service path: decode_order_frame ->
    admission -> device. One fetch of the per-bin vectors per step."""
    from ..bus.colwire import encode_order_frame

    symbols = [f"s{i}" for i in range(config.flow.n_lanes)]
    uuids = [f"u{i}" for i in range(config.flow.n_uids)]
    state, _ = env_reset(config, seed, resolve_device(device))
    frames: list[bytes] = []
    for _ in range(n_steps):
        state, _ops, _info, bins = _record_step(config, state)
        cols = bin_columns(bins)
        if cols["n"] == 0:
            continue
        frames.append(encode_order_frame(
            cols["n"], cols["action"], cols["side"], cols["kind"],
            cols["price"], cols["volume"], symbols, cols["symbol_idx"],
            uuids, cols["uuid_idx"], cols["oids"],
        ))
    return frames


def grid_host(ops) -> dict:
    """A DeviceOp grid as host numpy leaves by field name (the input of
    grid_to_columns / orders_from_grid)."""
    return {f: _host(getattr(ops, f)) for f in ops._fields}

