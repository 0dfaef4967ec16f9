"""Gym-style vectorized market environment over the stacked books.

The port of ``gome_tpu/sim/env.py``. One `step` injects the agent's ops into
the first `n_agent_ops` grid columns, generates a Hawkes/Zipf background
grid for the remaining columns (sim.flow), runs the batched match step
(``ops/match_step.py::batch_step``, the CUDA kernel K1 on the card) on the
`[S, ...]` book stack, and computes observations / reward / info from the
device-resident results. No step reads anything back to the host, so
`rollout` runs thousands of steps without a host sync (JAX-LOB,
arXiv:2308.13289 §4: the rollout loop must live on device or RL throughput
dies on the PCIe round trip).

Reward is mark-to-market PnL delta in float32 (cash + inventory * mid).
The matching arithmetic stays exact integer; the f32 here is diagnostic
reward shaping only, never book state. Its sums run in another order than
the reference's, so reward, cash and mark to market agree with it to
float32 rounding, not bit for bit. Integer sums wrap to int32 as the
reference's do.

Agent lanes out of range keep the reference's semantics: an index is
normalized once (lane < 0 counts from the end), a scatter drops it when it
is still out of range and a gather clamps it.

Capacity note: a rollout cannot host-escalate geometry the way `BatchEngine`
does, so overflow is *reported* per step (`StepInfo.book_overflow` /
`fill_overflow`) instead of replayed; size `book.cap` / `max_fills` for the
flow (cap 32 / K 8 keeps the counters zero over a 1000-step rollout with
the default flow).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..engine.batch import _guard_capped
from ..engine.book import (
    BookConfig,
    BookState,
    DeviceOp,
    init_books,
    resolve_device,
)
from ..ops import match_step
from .flow import Draws, FlowConfig, FlowState, _gen, flow_init


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment parameters."""

    flow: FlowConfig = FlowConfig()
    book: BookConfig = BookConfig(cap=16, max_fills=4, dtype=torch.int32)
    n_agent_ops: int = 2  # agent op slots per step (grid columns 0..A-1)
    obs_levels: int = 4  # resting slots exposed per side in Obs
    agent_uid: int = 1 << 20  # above any background uid

    def __post_init__(self) -> None:
        if self.n_agent_ops <= 0:
            raise ValueError("sim env n_agent_ops must be positive")
        if not 0 < self.obs_levels <= self.book.cap:
            raise ValueError(
                f"sim env obs_levels must be in [1, cap], got "
                f"{self.obs_levels} (cap {self.book.cap})"
            )
        if self.agent_uid <= self.flow.n_uids:
            raise ValueError(
                "sim env agent_uid must exceed flow.n_uids (background "
                "uids would alias the agent's fills)"
            )


class AgentAction(NamedTuple):
    """The agent's op slots for one step — each leaf is `[A]`. `action`
    0 (NOP) makes a slot inert; ADD slots must carry volume >= 1 and the
    agent's own oid handles (disjoint from background oids, which count
    up from 1 — use e.g. oids >= 2**24). The env stamps `uid` itself."""

    lane: torch.Tensor  # i32 symbol lane
    action: torch.Tensor  # i32 0=NOP, 1=ADD, 2=DEL
    side: torch.Tensor  # i32 0=BUY, 1=SALE
    is_market: torch.Tensor  # i32 bool
    price: torch.Tensor  # book dtype ticks (absolute)
    volume: torch.Tensor  # book dtype lots
    oid: torch.Tensor  # book dtype order-id handle


class EnvState(NamedTuple):
    books: BookState  # [S, ...] stacked
    flow: FlowState
    t: torch.Tensor  # i32 [] step counter
    cash: torch.Tensor  # f32 [] signed cash (diagnostic units)
    inv: torch.Tensor  # i32 [S] net agent inventory (lots) per lane
    mtm: torch.Tensor  # f32 [] mark-to-market at the end of last step


class Obs(NamedTuple):
    """Device-side L1/L2 view of the books. Depth slots are the top `L`
    *resting orders* per side in priority order (equal prices adjacent),
    masked to zero beyond `count` — aggregation to price levels is a host
    concern."""

    best_bid: torch.Tensor  # [S] book dtype (0 when side empty)
    best_ask: torch.Tensor  # [S]
    bid_prices: torch.Tensor  # [S, L]
    bid_lots: torch.Tensor  # [S, L]
    ask_prices: torch.Tensor  # [S, L]
    ask_lots: torch.Tensor  # [S, L]
    counts: torch.Tensor  # [S, 2] i32 resting orders per side
    mid: torch.Tensor  # [S] f32 (ref-banded fallback when a side is empty)
    lam: torch.Tensor  # [E] f32 current Hawkes intensities
    t: torch.Tensor  # i32 step counter


class StepInfo(NamedTuple):
    """Per-step diagnostics (all i32 scalars; sums wrap — `checksum` is
    the replay digest fold, not an exact count)."""

    events: torch.Tensor  # background + agent ops applied (action != 0)
    trades: torch.Tensor  # total fills (n_fills sum, incl. beyond-K)
    traded_qty: torch.Tensor  # lots traded (wrapping i32)
    fill_overflow: torch.Tensor  # fill records beyond K (0 = exact)
    book_overflow: torch.Tensor  # dropped resting inserts (0 = exact)
    cancels_missed: torch.Tensor  # DELs that found nothing
    agent_fills: torch.Tensor  # fills with the agent on either side
    checksum: torch.Tensor  # i32 [4] wrapping fold over the fill stream


def _sum32(x, dim=None) -> torch.Tensor:
    """Integer sum wrapped to int32 (the reference's `dtype=jnp.int32`
    sums): summed in int64, then the low 32 bits."""
    x = x.to(torch.int64)
    total = x.sum() if dim is None else x.sum(dim=dim)
    return total.to(torch.int32)


def null_action(config: EnvConfig, device=None) -> AgentAction:
    """All-NOP agent action (background flow only)."""
    device = resolve_device(device)
    a = config.n_agent_ops
    z32 = torch.zeros(a, dtype=torch.int32, device=device)
    zdt = torch.zeros(a, dtype=config.book.dtype, device=device)
    return AgentAction(
        lane=z32, action=z32, side=z32, is_market=z32,
        price=zdt, volume=zdt, oid=zdt,
    )


def _mid(config: EnvConfig, books: BookState) -> torch.Tensor:
    """[S] f32 mid price with the flow's reference band as fallback."""
    ref = float(config.flow.ref_price)
    half = float(config.flow.ref_spread)
    f32 = torch.float32
    bb = torch.where(books.count[:, 0] > 0, books.price[:, 0, 0].to(f32),
                     float(np.float32(ref - half)))
    ba = torch.where(books.count[:, 1] > 0, books.price[:, 1, 0].to(f32),
                     float(np.float32(ref + half)))
    return 0.5 * (bb + ba)


def _observe(config: EnvConfig, books: BookState, flow: FlowState, t) -> Obs:
    ell = config.obs_levels
    slots = torch.arange(ell, dtype=torch.int32, device=books.count.device)
    live = slots[None, None, :] < books.count[:, :, None]  # [S, 2, L]
    prices = torch.where(live, books.price[:, :, :ell], 0)
    lots = torch.where(live, books.lots[:, :, :ell], 0)
    return Obs(
        best_bid=torch.where(books.count[:, 0] > 0, books.price[:, 0, 0], 0),
        best_ask=torch.where(books.count[:, 1] > 0, books.price[:, 1, 0], 0),
        bid_prices=prices[:, 0], bid_lots=lots[:, 0],
        ask_prices=prices[:, 1], ask_lots=lots[:, 1],
        counts=books.count,
        mid=_mid(config, books),
        lam=flow.lam,
        t=t,
    )


def _agent_rows(config: EnvConfig, lane: torch.Tensor):
    """The agent slots' lanes as rows: (row clamped into [0, S), whether
    the reference's scatter keeps the slot). JAX normalizes a negative
    index once, drops a scatter index still out of range and clamps a
    gather index; row serves the gather, and a dropped slot scatters
    zeros (its grid column is its own, so that writes nothing)."""
    s = config.flow.n_lanes
    lane = lane.long()
    norm = torch.where(lane < 0, lane + s, lane)
    keep = (norm >= 0) & (norm < s)
    return norm.clamp(0, s - 1), keep


def _agent_grid(config: EnvConfig, act: AgentAction) -> DeviceOp:
    """Scatter the agent's [A] op slots into an [S, A] grid (slot a owns
    column a, so agent ops never collide and keep their order)."""
    s, a = config.flow.n_lanes, config.n_agent_ops
    dt = config.book.dtype
    dev = act.action.device
    row, keep = _agent_rows(config, act.lane)
    cols = torch.arange(a, device=dev)
    on32 = ((act.action != 0) & keep).to(torch.int32)
    ondt = on32.to(dt)
    fields = {
        "action": (act.action * on32, torch.int32),
        "side": (act.side * on32, torch.int32),
        "is_market": (act.is_market * on32, torch.int32),
        "price": (act.price * ondt, dt),
        "volume": (act.volume * ondt, dt),
        "oid": (act.oid * ondt, dt),
        "uid": (config.agent_uid * ondt, dt),
    }

    def scat(v, d):
        out = torch.zeros((s, a), dtype=d, device=dev)
        out[row, cols] = v.to(d)
        return out

    return DeviceOp(**{f: scat(v, d) for f, (v, d) in fields.items()})


def env_reset(config: EnvConfig, seed: int, device=None):
    """Empty books and a fresh flow seeded with ``seed`` on ``device``
    (default: the CUDA card). Returns (state, obs)."""
    device = resolve_device(device)
    books = init_books(config.book, config.flow.n_lanes, device)
    flow = flow_init(config.flow, seed, device)
    t = torch.zeros((), dtype=torch.int32, device=device)
    state = EnvState(
        books=books, flow=flow, t=t,
        cash=torch.zeros((), dtype=torch.float32, device=device),
        inv=torch.zeros(config.flow.n_lanes, dtype=torch.int32, device=device),
        mtm=torch.zeros((), dtype=torch.float32, device=device),
    )
    return state, _observe(config, books, flow, t)


def _env_step(config: EnvConfig, state: EnvState, act: AgentAction,
              draws: Draws | None = None):
    """env_step, also returning the background grid and its ops in bin
    order (flow.Bins)."""
    a = config.n_agent_ops
    flow2, bg_ops, bins = _gen(config.flow, state.flow, state.books, draws)
    ops = DeviceOp(*(torch.cat([x, y], dim=1)
                     for x, y in zip(_agent_grid(config, act), bg_ops)))
    books2, outs = match_step.batch_step(config.book, state.books, ops)
    outs = _guard_capped(outs, state.books.count, config.book.cap, ops)

    # -- agent PnL (f32 cash, i32 per-lane inventory) ----------------------
    f32 = torch.float32
    qty = outs.fill_qty.to(f32)  # [S, T, K]
    price = outs.fill_price.to(f32)
    filled = outs.fill_qty > 0
    # Maker side: taker's side is the op's side; the maker BUYS when the
    # taker sells (side == 1) and vice versa.
    maker = filled & (outs.maker_uid == config.agent_uid)
    taker_sells = ops.side[:, :, None] == 1
    mk_sign = torch.where(taker_sells, 1.0, -1.0) * maker
    inv_maker = _sum32(outs.fill_qty.to(torch.int64)
                       * torch.where(taker_sells, 1, -1) * maker,
                       dim=(1, 2))  # [S]
    cash_maker = -(mk_sign * qty * price).sum()
    # Taker side: the agent's own op slots live at known coordinates
    # (act.lane, column a) — sum their fill records directly.
    row, keep = _agent_rows(config, act.lane)
    cols = torch.arange(a, device=row.device)
    t_qty = outs.fill_qty[row, cols]  # [A, K]
    t_prc = price[row, cols]
    t_sign = torch.where(act.side == 0, 1, -1)[:, None]  # buy: +inv, -cash
    inv_taker = torch.zeros_like(state.inv, dtype=torch.int64).index_add_(
        0, row, _sum32(t_qty.to(torch.int64) * t_sign, dim=1).long() * keep
    )
    cash_taker = -(t_qty.to(f32) * t_prc * t_sign.to(f32)).sum()
    inv2 = (state.inv.long() + inv_maker + inv_taker).to(torch.int32)
    cash2 = state.cash + cash_maker + cash_taker
    agent_fills = (_sum32(maker) + _sum32(t_qty > 0)).to(torch.int32)

    t2 = state.t + 1
    obs = _observe(config, books2, flow2, t2)
    mtm2 = cash2 + (inv2.to(f32) * obs.mid).sum()
    reward = mtm2 - state.mtm

    q = outs.fill_qty.to(torch.int32).long()
    checksum = torch.stack([
        _sum32(outs.n_fills),
        _sum32(q),
        _sum32(q * outs.fill_price.to(torch.int32)),
        _sum32(q * outs.maker_oid.to(torch.int32)),
    ])
    info = StepInfo(
        events=_sum32(ops.action != 0),
        trades=_sum32(outs.n_fills),
        traded_qty=_sum32(q),
        fill_overflow=_sum32(outs.fill_overflow),
        book_overflow=_sum32(outs.book_overflow),
        cancels_missed=_sum32((ops.action == 2) & (outs.cancel_found == 0)),
        agent_fills=agent_fills,
        checksum=checksum,
    )
    state2 = EnvState(
        books=books2, flow=flow2, t=t2, cash=cash2, inv=inv2, mtm=mtm2
    )
    return state2, obs, reward, info, bg_ops, bins


def env_step(config: EnvConfig, state: EnvState, act: AgentAction,
             draws: Draws | None = None):
    """One transition: `(state, act) -> (state', obs, reward, info)`.
    ``draws`` replaces the background grid's random numbers (see
    flow.gen_ops). Pure: the same inputs give the same outputs."""
    state2, obs, reward, info, _, _ = _env_step(config, state, act, draws)
    return state2, obs, reward, info


def rollout(config: EnvConfig, state: EnvState, n_steps: int):
    """Background-only rollout: `n_steps` env transitions with no host sync
    (nothing is read back until the caller reads the result). Returns the
    final state and the stacked per-step (reward [n], StepInfo of [n]
    leaves) trajectory."""
    nop = null_action(config, state.cash.device)
    rewards, infos = [], []
    for _ in range(int(n_steps)):
        state, _obs, reward, info = env_step(config, state, nop)
        rewards.append(reward)
        infos.append(info)
    traj = StepInfo(*(torch.stack(leaf) for leaf in zip(*infos)))
    return state, (torch.stack(rewards), traj)


def env_state_from_numpy(config: EnvConfig, leaves, seed: int,
                         device=None) -> EnvState:
    """A reference EnvState, fetched to the host (numpy leaves with the
    reference's field names), as the port's: books, lam, next_oid,
    t_model, t, cash, inv and mtm carry over; a JAX key cannot, so the
    generator is seeded anew with ``seed``."""
    device = resolve_device(device)
    dt = config.book.dtype

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)

    i32 = torch.int32
    b = leaves.books
    books = BookState(
        price=tensor(b.price, dt), lots=tensor(b.lots, dt),
        seq=tensor(b.seq, i32), oid=tensor(b.oid, dt), uid=tensor(b.uid, dt),
        count=tensor(b.count, i32), next_seq=tensor(b.next_seq, i32),
    )
    fresh = flow_init(config.flow, seed, device)
    f = leaves.flow
    flow = FlowState(
        lam=tensor(f.lam, torch.float32), rng=fresh.rng,
        next_oid=tensor(f.next_oid, i32),
        t_model=tensor(f.t_model, torch.float32),
    )
    return EnvState(
        books=books, flow=flow, t=tensor(leaves.t, i32),
        cash=tensor(leaves.cash, torch.float32), inv=tensor(leaves.inv, i32),
        mtm=tensor(leaves.mtm, torch.float32),
    )


class MarketEnv:
    """Thin OO wrapper over the pure entries (reset/step/rollout) for
    callers that prefer holding the config once."""

    def __init__(self, config: EnvConfig | None = None, device=None):
        self.config = config if config is not None else EnvConfig()
        self.device = resolve_device(device)

    def reset(self, seed: int):
        return env_reset(self.config, seed, self.device)

    def step(self, state, action, draws: Draws | None = None):
        return env_step(self.config, state, action, draws)

    def null_action(self):
        return null_action(self.config, self.device)

    def rollout(self, state, n_steps: int):
        return rollout(self.config, state, int(n_steps))
