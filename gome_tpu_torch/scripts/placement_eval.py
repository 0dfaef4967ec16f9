"""What-if placement evaluator: score candidate symbol->shard policies
against the committed Zipf workload, host-side only (the port of
scripts/placement_eval.py).

The port's mesh artifact (``MULTICHIP_CUDA_r01.json``: the D=8 dense
shard skew, every shard padded to the hottest shard's row block) and its
fleet artifact (``FLEET_CUDA_r01.json``: the partition order imbalance)
say what naive placement costs; this evaluator says which policy would
fix it. It replays the symbol-flow profile the mesh curve measured —
``np.random.default_rng(17)``, ``zipf(1.2, S // 4) % S`` over S=4096
symbols — against candidate placement policies and predicts, per policy:

  * partition_imbalance_max_over_mean — per-partition order flow skew
  * shard_skew — max per-shard live-lane count x D / live
  * rows_per_live_lane — the dense packer's real cost under its
    uniform-R_s pow2 row bucketing (engine.batch._grid_geometry)
  * padding_bytes_per_order — wasted op-grid bytes at the committed
    geometry (t=16, int32 cells)
  * symbols_moved_vs_current — migration cost vs today's layout

Pure host arithmetic over the recorded flow — no serving-path change, no
device, no clock — so two runs give byte-identical verdicts. The verdict
(schema ``gome-placement-verdict-v1``) carries the policy x metric table,
the skew-attribution rows reconciled against the port's mesh artifact,
and a named winner. It equals the reference's PLACEMENT_r01.json apart
from the artifact names and the method text: the geometry is the same
host arithmetic on both sides.

Policies:

  current_block     today's engine layout: interner-ordered lanes in
                    contiguous per-shard blocks (lane // (S/D)) — must
                    reproduce the mesh artifact's measured skew exactly.
  fnv1a_mod         the fleet's partition policy applied to lanes
                    (fleet.router.partition_of).
  consistent_hash   a 64-vnode-per-shard hash ring over the symbol
                    names (fnv1a points, bisect lookup).
  greedy_lpt        longest-processing-time flow balancing: symbols in
                    descending flow order, each to the least-flow-loaded
                    shard (ties: fewest lanes, lowest shard id).

    python -m gome_tpu_torch.scripts.placement_eval         # print verdict
    python -m gome_tpu_torch.scripts.placement_eval --out PLACEMENT_CUDA_r01.json

It reads MULTICHIP_CUDA_r01.json at the repo root (run mesh_overhead
--curve first); without it the attribution's observed row is the
replay's own.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

import numpy as np

from ..fleet.router import partition_of
from ..obs.placement import SCHEMA, VERDICT_ARTIFACT, shard_skew_baseline
from ..parallel.router import fnv1a
from .common import require_device, zipf_draws

# The committed mesh curve's workload + geometry, pinned (see
# mesh_overhead.curve()): one fixed Zipf(1.2) live set over 4096
# symbols, dispatched dense at D=8, t=16, int32 books.
SEED = 17
SYMBOLS = 4096
ZIPF_A = 1.2
DEVICES = 8
T = 16
CAP = 64
#: int32 op-grid cell: 3 x int32 index fields + 4 x int32 value fields.
CELL_BYTES = 3 * 4 + 4 * 4
VNODES = 64
WINNER_SKEW_BUDGET = 1.3
RECONCILE_TOL = 0.05


def workload():
    """The committed flow profile: per-symbol arrival counts + live set
    (the mesh curve's draw: rng 17, zipf(1.2, S//4) % S, as numpy 2.0
    draws it under any numpy: common.zipf_draws)."""
    rng = np.random.default_rng(SEED)
    draws = zipf_draws(rng, ZIPF_A, SYMBOLS // 4) % SYMBOLS
    flow = np.bincount(draws, minlength=SYMBOLS)
    live = np.flatnonzero(flow)
    names = [f"SYM{i:04d}" for i in live]
    return flow[live].astype(np.int64), live.astype(np.int64), names


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# -- candidate policies: live-symbol array -> shard id array --------------


def policy_current_block(live: np.ndarray, names, flow) -> np.ndarray:
    """Today's layout: interner order, contiguous per-shard lane blocks
    (engine.batch._grid_geometry: shard = lane // (n_slots / D))."""
    return live // (SYMBOLS // DEVICES)


def policy_fnv1a_mod(live, names, flow) -> np.ndarray:
    """The fleet hash applied at lane granularity."""
    return np.array([partition_of(n, DEVICES) for n in names], np.int64)


def policy_consistent_hash(live, names, flow) -> np.ndarray:
    """Hash ring over the symbol names: VNODES points per shard, a
    symbol owned by the first ring point at or clockwise of its own hash
    (wrapping)."""
    points = sorted(
        (fnv1a(f"shard{p}/vnode{v}"), p)
        for p in range(DEVICES)
        for v in range(VNODES)
    )
    keys = [pt[0] for pt in points]
    owners = [pt[1] for pt in points]
    out = np.empty(len(names), np.int64)
    for i, n in enumerate(names):
        j = bisect.bisect_left(keys, fnv1a(n))
        out[i] = owners[j if j < len(owners) else 0]
    return out


def policy_greedy_lpt(live, names, flow) -> np.ndarray:
    """Greedy LPT flow balancing: heaviest symbol first, each to the
    shard with the least assigned flow (ties: fewest lanes, lowest id).
    Deterministic: ties in flow break on symbol id."""
    order = sorted(range(len(live)),
                   key=lambda i: (-int(flow[i]), int(live[i])))
    loads = [0] * DEVICES
    lanes = [0] * DEVICES
    out = np.empty(len(live), np.int64)
    for i in order:
        g = min(range(DEVICES), key=lambda d: (loads[d], lanes[d], d))
        out[i] = g
        loads[g] += int(flow[i])
        lanes[g] += 1
    return out


POLICIES = (
    ("current_block", policy_current_block),
    ("fnv1a_mod", policy_fnv1a_mod),
    ("consistent_hash", policy_consistent_hash),
    ("greedy_lpt", policy_greedy_lpt),
)


def score(groups: np.ndarray, flow: np.ndarray, current: np.ndarray) -> dict:
    """Predicted cost of one placement under the engine's dense geometry:
    uniform per-shard row block R_s = pow2(max live count, min 8), every
    shard dispatching R_s rows (_grid_geometry)."""
    counts = np.bincount(groups, minlength=DEVICES)
    flows = np.bincount(groups, weights=flow, minlength=DEVICES)
    n_live = int(len(groups))
    orders = int(flow.sum())
    mx = int(counts.max())
    r_s = max(8, _next_pow2(mx))
    rows = r_s * DEVICES
    return {
        "partition_imbalance_max_over_mean": round(
            float(flows.max()) / (orders / DEVICES), 4),
        "shard_skew": round(mx * DEVICES / n_live, 4),
        "r_s": r_s,
        "dispatched_rows": rows,
        "rows_per_live_lane": round(rows / n_live, 4),
        "padding_bytes_per_order": round(
            (rows - n_live) * T * CELL_BYTES / orders, 2),
        "symbols_moved_vs_current": round(
            float((groups != current).mean()), 4),
        "live_per_shard": [int(c) for c in counts],
    }


def build_verdict() -> dict:
    """The full deterministic verdict document (no clocks, no host state:
    same inputs, same bytes)."""
    flow, live, names = workload()
    orders = int(flow.sum())
    n_live = int(len(live))
    top16 = np.sort(flow)[::-1][:16]

    current = policy_current_block(live, names, flow)
    table = []
    for name, fn in POLICIES:
        row = {"policy": name}
        row.update(score(fn(live, names, flow), flow, current))
        table.append(row)

    # Attribution: decompose the current policy's predicted cost and
    # reconcile it against the port's mesh artifact — the replay is only
    # trustworthy if it reproduces the observation it claims to explain.
    cur = table[0]
    skew = cur["shard_skew"]
    padding = cur["r_s"] / max(cur["live_per_shard"])
    product = skew * padding
    baseline = shard_skew_baseline() or {}
    observed = baseline.get("rows_per_live_lane") or cur["rows_per_live_lane"]
    frac = abs(product - observed) / observed
    skew_frac = (
        abs(skew - baseline["shard_skew"]) / baseline["shard_skew"]
        if baseline.get("shard_skew") else 0.0
    )
    attribution = {
        "observed": {
            "artifact": baseline.get("artifact"),
            "rows_per_live_lane": observed,
            "shard_skew": baseline.get("shard_skew"),
        },
        "components": [
            {"component": "lane_placement_skew", "value": round(skew, 4)},
            {"component": "cap_class_padding", "value": round(padding, 4)},
        ],
        "reconciliation": {
            "product": round(product, 4),
            "frac_err": round(frac, 6),
            "within_tol": frac <= RECONCILE_TOL,
            "replayed_skew_frac_err": round(skew_frac, 6),
            "tol": RECONCILE_TOL,
        },
    }

    winner = min(
        table,
        key=lambda r: (r["rows_per_live_lane"],
                       r["partition_imbalance_max_over_mean"], r["policy"]),
    )
    checks = {
        "attribution_reconciles": attribution["reconciliation"]["within_tol"],
        "replay_matches_committed_skew": skew_frac <= RECONCILE_TOL,
        "winner_shard_skew_le": WINNER_SKEW_BUDGET,
        "winner_within_budget": winner["shard_skew"] <= WINNER_SKEW_BUDGET,
    }
    checks["pass"] = all(v for v in checks.values() if isinstance(v, bool))
    return {
        "schema": SCHEMA,
        "artifact": VERDICT_ARTIFACT,
        "method": (
            "host-side what-if replay of the port's MULTICHIP_CUDA_r01 "
            f"Zipf({ZIPF_A}) flow (rng {SEED}, zipf(a, S//4) % S, "
            f"S={SYMBOLS}) against {len(POLICIES)} placement policies; "
            "each scored under the engine's dense geometry (uniform R_s = "
            "pow2(max per-shard live), gome_tpu_torch.engine.batch."
            "_grid_geometry) at the committed t=16/int32 cell cost. "
            "Deterministic: no clocks, no device."
        ),
        "workload": {
            "seed": SEED,
            "symbols": SYMBOLS,
            "zipf_a": ZIPF_A,
            "orders": orders,
            "live_lanes": n_live,
            "devices": DEVICES,
            "t": T,
            "cap": CAP,
            "cell_bytes": CELL_BYTES,
            "top16_share": round(float(top16.sum()) / orders, 4),
        },
        "attribution": attribution,
        "policies": table,
        "winner": {
            "policy": winner["policy"],
            "predicted_shard_skew": winner["shard_skew"],
            "predicted_rows_per_live_lane": winner["rows_per_live_lane"],
            "rule": ("min rows_per_live_lane, then "
                     "partition_imbalance_max_over_mean, then policy name"),
        },
        "checks": checks,
    }


def verdict_text(doc: dict) -> str:
    """The verdict's bytes as the artifact holds them."""
    return json.dumps(doc, indent=1) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the verdict JSON here (default: stdout)")
    ap.add_argument("--device", default=None,
                    help="the run's device (default: the CUDA card; the "
                         "verdict itself is host arithmetic)")
    args = ap.parse_args(argv)
    require_device(args.device)
    doc = build_verdict()
    text = verdict_text(doc)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.out}: winner={doc['winner']['policy']} "
              f"(skew {doc['winner']['predicted_shard_skew']}), "
              f"pass={doc['checks']['pass']}")
    else:
        print(text, end="")
    return 0 if doc["checks"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
