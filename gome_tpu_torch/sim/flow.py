"""Hawkes/Zipf order-flow generator on torch tensors.

The port of ``gome_tpu/sim/flow.py``. Model (arXiv:2510.08085 §2,
discretized): six event types — {submit, cancel, market} x {buy, sell} —
share a multivariate Hawkes intensity vector lambda[E] with exponential
kernels:

    lambda_i(t) = mu_i + sum_j sum_{t_k^j < t} alpha[i][j] exp(-beta (t - t_k^j))

Each generated grid discretizes `t_bins` micro-bins of width `dt`; per bin
at most one event occurs (Bernoulli thinning with p = 1 - exp(-Lambda dt)),
its type is categorical in lambda, its symbol lane is Zipf(a)-categorical,
and the intensity vector decays and self/cross-excites per bin. Stationarity
requires the branching matrix alpha/beta to have spectral radius < 1
(:meth:`FlowConfig.branching_ratio`).

A grid is made in three steps: ``draw_bins`` draws every random number of
the grid in a few batched calls; ``ops/hawkes_scan.py::hawkes_scan`` runs
the bins' serial chain (the CUDA kernel K5 on the card); then placement,
cancel targeting and the scatter into the ``[S, T]`` grid run as tensor
code against the frame-start books.

Placement: limit orders price at a geometric offset from the *opposite*
best quote (offset 0 = a marketable limit at the touch; larger offsets rest
deeper), falling back to a reference band when the book side is empty.
Cancels target a uniformly random resting slot of the lane's book (gathered
oid + exact resting price); an empty side yields a deliberate miss (oid 0 is
never assigned).

Random bits: the generator's state is carried *in* ``FlowState.rng`` (a
``torch.Generator`` state); each grid builds a generator on the state's
device from it and stores the advanced state in the new FlowState, so
``gen_ops`` is a pure function of its inputs, as the reference's jitted one
is. torch's bits are not ``jax.random``'s, and a CUDA generator's are not a
CPU one's: a caller that needs equal grids across packages or devices hands
in the same draws through ``draws=``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..engine.book import GRID_I32_FIELDS, BookState, DeviceOp, resolve_device
from ..ops import hawkes_scan as _k5

# Event-type index = kind * 2 + side (kind: 0 submit, 1 cancel, 2 market;
# side: 0 BUY, 1 SALE) — so `etype % 2` is the side and `etype // 2` the
# kind, branch-free.
EV_SUBMIT_BUY = 0
EV_SUBMIT_SALE = 1
EV_CANCEL_BUY = 2
EV_CANCEL_SALE = 3
EV_MARKET_BUY = 4
EV_MARKET_SALE = 5
N_EVENT_TYPES = 6


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Static flow-generator parameters.

    Intensities are per model-time unit; `dt` is the micro-bin width, so
    the per-bin event probability is 1 - exp(-sum(mu-ish) * dt) and one
    generated grid spans `t_bins * dt` model time. The excitation matrix
    is structured: an event adds `excite_self` to its own type's
    intensity, `excite_cross` to the same kind's opposite side, and
    `excite_kind` to every other type (all scaled by `decay` so the
    *branching* contribution alpha/beta is exactly those numbers — row
    sums must stay < 1)."""

    n_lanes: int = 256
    t_bins: int = 32
    dt: float = 0.02
    # Base intensities per kind (split evenly across the two sides).
    submit_rate: float = 2.0
    cancel_rate: float = 1.4
    market_rate: float = 0.6
    # Branching fractions (alpha = these * decay).
    excite_self: float = 0.25
    excite_cross: float = 0.10
    excite_kind: float = 0.05
    decay: float = 2.0
    zipf_a: float = 1.1
    # Geometric placement offset from the opposite touch (p = offset_p;
    # offset 0 = marketable limit) clamped to max_offset ticks.
    offset_p: float = 0.35
    max_offset: int = 200
    ref_price: int = 100_000  # empty-book fallback mid (ticks)
    ref_spread: int = 20  # fallback half-spread (ticks)
    vol_max: int = 100  # volumes uniform in [1, vol_max] lots
    n_uids: int = 256  # background uids in [1, n_uids]

    def __post_init__(self) -> None:
        if self.n_lanes <= 0 or self.t_bins <= 0:
            raise ValueError("sim flow n_lanes/t_bins must be positive")
        if self.dt <= 0 or self.decay <= 0:
            raise ValueError("sim flow dt/decay must be positive")
        if not (self.submit_rate > 0 or self.cancel_rate > 0
                or self.market_rate > 0):
            raise ValueError("sim flow needs a positive base rate")
        if self.vol_max <= 0 or self.n_uids <= 0:
            raise ValueError("sim flow vol_max/n_uids must be positive")
        if not 0 < self.offset_p < 1:
            raise ValueError(
                f"sim flow offset_p must be in (0, 1), got {self.offset_p}"
            )
        if self.ref_price <= self.ref_spread:
            raise ValueError("sim flow ref_price must exceed ref_spread")
        br = self.branching_ratio()
        if br >= 1.0:
            raise ValueError(
                f"sim flow Hawkes process is unstable: branching ratio "
                f"{br:.3f} >= 1 (lower excite_* or raise decay)"
            )
        # Thinning validity: with <= 1 event per bin, the discretization
        # saturates when the stationary rate mu_total / (1 - n) fills a
        # bin with high probability — the Bernoulli cap then clips the
        # excitation (the realized process stops being Hawkes: branching
        # collapses and counts go UNDERdispersed).
        rate = float(self.mu().sum()) / (1.0 - br)
        p_bin = 1.0 - math.exp(-rate * self.dt)
        if p_bin > 0.6:
            raise ValueError(
                f"sim flow dt too coarse: stationary per-bin event "
                f"probability {p_bin:.2f} > 0.6 saturates the one-event-"
                f"per-bin thinning (lower dt or the base rates)"
            )

    # -- derived model parameters (host-side, static) ---------------------
    def mu(self) -> np.ndarray:
        """Base intensity per event type [E] (kind rate split per side)."""
        per_side = [self.submit_rate / 2, self.cancel_rate / 2,
                    self.market_rate / 2]
        return np.repeat(np.asarray(per_side, np.float64), 2)

    def alpha(self) -> np.ndarray:
        """Excitation jump matrix [E, E]: event of type j adds
        alpha[i, j] to intensity i."""
        a = np.full((N_EVENT_TYPES, N_EVENT_TYPES),
                    self.excite_kind, np.float64)
        for j in range(N_EVENT_TYPES):
            a[j, j] = self.excite_self
            a[j ^ 1, j] = self.excite_cross  # same kind, opposite side
        return a * self.decay

    def branching_ratio(self) -> float:
        """Spectral radius of the branching matrix alpha/beta — the
        Hawkes stability bound (< 1 <=> stationary; arXiv:2510.08085
        eq. 4). With the structured alpha the all-ones vector is the
        Perron eigenvector, but compute it generally."""
        m = self.alpha() / self.decay
        return float(np.max(np.abs(np.linalg.eigvals(m))))


class FlowState(NamedTuple):
    """Generator state, on the device but for ``rng``."""

    lam: torch.Tensor  # f32 [E] current Hawkes intensities
    rng: torch.Tensor  # uint8: the torch.Generator's state (host tensor)
    next_oid: torch.Tensor  # i32 [] next order-id handle (0 never assigned)
    t_model: torch.Tensor  # f32 [] elapsed model time (diagnostics)


class Draws(NamedTuple):
    """Every random number of one grid, one entry per bin ([T])."""

    u_ev: torch.Tensor  # f32 uniform: the occurrence draw
    g_ty: torch.Tensor  # f32 [T, E] Gumbel noise -log(-log u) for the type
    lane: torch.Tensor  # i32 symbol lane, Zipf(a) (lane 0 the hottest)
    u_price: torch.Tensor  # f32 uniform: the placement offset
    u_cancel: torch.Tensor  # f32 uniform: the cancel's resting slot
    vol: torch.Tensor  # i32 in [1, vol_max]
    uid: torch.Tensor  # i32 in [1, n_uids]


def flow_init(config: FlowConfig, seed: int, device=None) -> FlowState:
    """Fresh generator state at the base intensity, its generator seeded
    with ``seed`` on ``device`` (default: the CUDA card)."""
    lam = torch.tensor(config.mu(), dtype=torch.float32,
                       device=resolve_device(device))
    device = lam.device  # with its index: the key draw_bins looks up
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    _zipf_cdf(config, device)  # built here, never inside a step
    return FlowState(
        lam=lam,
        rng=gen.get_state(),
        next_oid=torch.ones((), dtype=torch.int32, device=device),
        t_model=torch.zeros((), dtype=torch.float32, device=device),
    )


def _zipf_logits(config: FlowConfig, device=None) -> torch.Tensor:
    """Static log-weights for Zipf(a) symbol popularity over ranks
    1..n_lanes (lane 0 is the hottest symbol), float32 as the
    reference's."""
    ranks = np.arange(1, config.n_lanes + 1, dtype=np.float64)
    logits = (-config.zipf_a * np.log(ranks)).astype(np.float32)
    return torch.from_numpy(logits).to(resolve_device(device))


_CDF_CACHE: dict[tuple, torch.Tensor] = {}


def _zipf_cdf(config: FlowConfig, device) -> torch.Tensor:
    """The Zipf(a) lane CDF in float64 on ``device`` (float64 keeps the
    tail of 10,240 lanes its weights), built once per (lanes, a, device)
    with device ops only."""
    key = (config.n_lanes, config.zipf_a, str(device))
    cdf = _CDF_CACHE.get(key)
    if cdf is None:
        ranks = torch.arange(1, config.n_lanes + 1, dtype=torch.float64,
                             device=device)
        cdf = torch.cumsum(torch.exp(-config.zipf_a * torch.log(ranks)), 0)
        cdf = cdf / cdf[-1]
        _CDF_CACHE[key] = cdf
    return cdf


def draw_bins(config: FlowConfig, rng: torch.Tensor, t_bins: int,
              device) -> tuple[Draws, torch.Tensor]:
    """Every random number of a grid of ``t_bins`` bins, drawn on
    ``device`` from the generator state ``rng``. Returns the draws and the
    advanced generator state."""
    gen = torch.Generator(device=device)
    gen.set_state(rng)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    i32 = dict(dtype=torch.int32, device=device, generator=gen)
    u_ev = torch.rand(t_bins, **f32)
    u_ty = torch.rand((t_bins, N_EVENT_TYPES), **f32)
    g_ty = -torch.log(-torch.log(u_ty.clamp_(min=torch.finfo(torch.float32).tiny)))
    u_lane = torch.rand(t_bins, dtype=torch.float64, device=device,
                        generator=gen)
    lane = torch.searchsorted(_zipf_cdf(config, device), u_lane, right=True)
    lane = lane.clamp_(max=config.n_lanes - 1).to(torch.int32)
    u_price = torch.rand(t_bins, **f32)
    u_cancel = torch.rand(t_bins, **f32)
    vol = torch.randint(1, config.vol_max + 1, (t_bins,), **i32)
    uid = torch.randint(1, config.n_uids + 1, (t_bins,), **i32)
    return (Draws(u_ev, g_ty, lane, u_price, u_cancel, vol, uid),
            gen.get_state())


class Bins(NamedTuple):
    """One grid's resolved ops in bin order ([T] each, zero where no event
    occurred): the grid is these scattered to (lane, bin)."""

    lane: torch.Tensor  # i32
    action: torch.Tensor  # i32
    side: torch.Tensor  # i32
    is_market: torch.Tensor  # i32
    price: torch.Tensor  # book dtype
    volume: torch.Tensor  # book dtype
    oid: torch.Tensor  # book dtype
    uid: torch.Tensor  # book dtype


def _resolve(config: FlowConfig, books: BookState, draws: Draws,
             scan) -> Bins:
    """Placement and cancel targeting against the frame-start books ([T]
    gathers), in the reference's float32 constants and operation order."""
    dtype = books.price.dtype
    i32 = torch.int32
    lane = draws.lane.long()
    etype = scan.etype
    occur = scan.occur
    kind = etype // 2  # 0 submit, 1 cancel, 2 market
    side = etype % 2
    is_cancel = (kind == 1).to(i32)
    is_market = (kind == 2).to(i32)

    cnt = books.count[lane]  # [T, 2] i32
    best_bid = torch.where(cnt[:, 0] > 0, books.price[lane, 0, 0],
                           config.ref_price - config.ref_spread)
    best_ask = torch.where(cnt[:, 1] > 0, books.price[lane, 1, 0],
                           config.ref_price + config.ref_spread)
    # Geometric offset from the opposite touch: k = floor(log(1-u) /
    # log(1-p)) in {0, 1, ...}; k = 0 is a marketable limit.
    k_off = torch.floor(
        torch.log1p(-draws.u_price * float(np.float32(1.0 - 1e-7)))
        * float(np.float32(1.0 / math.log(1.0 - config.offset_p)))
    ).to(i32)
    k_off = k_off.clamp_(max=config.max_offset).to(dtype)
    limit_price = torch.where(side == 0, best_ask - k_off, best_bid + k_off)
    limit_price = limit_price.clamp_(min=1)

    # -- cancel targeting: uniform resting slot of the lane's side --------
    side_l = side.long()
    n_side = cnt.gather(1, side_l[:, None])[:, 0]  # [T]
    slot = torch.minimum(
        (draws.u_cancel * n_side.to(torch.float32)).to(i32),
        (n_side - 1).clamp_(min=0),
    ).long()
    hit = n_side > 0
    # Miss: oid 0 / price 0 never matches a resting order (oids start at
    # 1, prices at 1) — the engine reports cancel_found=0, same as the
    # oracle's not-found path.
    c_oid = torch.where(hit, books.oid[lane, side_l, slot], 0)
    c_price = torch.where(hit, books.price[lane, side_l, slot], 0)
    c_uid = books.uid[lane, side_l, slot]

    cancel = is_cancel > 0
    action = occur * (1 + is_cancel)
    price = torch.where(cancel, c_price,
                        torch.where(is_market > 0, 0, limit_price))
    oid = torch.where(cancel, c_oid, scan.oid.to(dtype))
    volume = torch.where(cancel, 0, draws.vol.to(dtype))
    # A hitting cancel is issued by the resting order's OWNER (the service
    # pre-pool keys on symbol:uuid:oid — a random uid there would miss).
    uid = torch.where(cancel & hit, c_uid.to(i32), draws.uid)

    mask_dt = occur.to(dtype)
    return Bins(
        lane=draws.lane, action=action, side=side * occur,
        is_market=is_market * occur, price=price * mask_dt,
        volume=volume * mask_dt, oid=oid * mask_dt,
        uid=uid.to(dtype) * mask_dt,
    )


def _scatter(config: FlowConfig, bins: Bins, dtype) -> DeviceOp:
    """The [S, T] grid: bin t's op at (lane[t], t), NOPs elsewhere (each
    bin owns one column, so cells never collide)."""
    s, t = config.n_lanes, bins.lane.shape[0]
    dev = bins.lane.device
    at = (bins.lane.long(), torch.arange(t, device=dev))

    def scat(name):
        d = torch.int32 if name in GRID_I32_FIELDS else dtype
        out = torch.zeros((s, t), dtype=d, device=dev)
        out[at] = getattr(bins, name).to(d)
        return out

    return DeviceOp(*(scat(f) for f in DeviceOp._fields))


def _gen(config: FlowConfig, state: FlowState, books: BookState,
         draws: Draws | None = None):
    """gen_ops, also returning the grid's ops in bin order (Bins)."""
    dev = state.lam.device
    rng = state.rng
    if draws is None:
        draws, rng = draw_bins(config, rng, config.t_bins, dev)
    scan = _k5.hawkes_scan(config, state.lam, state.next_oid, draws.u_ev,
                           draws.g_ty)
    bins = _resolve(config, books, draws, scan)
    new_state = FlowState(
        lam=scan.lam, rng=rng, next_oid=scan.next_oid,
        t_model=state.t_model + config.t_bins * config.dt,
    )
    return new_state, _scatter(config, bins, books.price.dtype), bins


def gen_ops(config: FlowConfig, state: FlowState, books: BookState,
            draws: Draws | None = None) -> tuple[FlowState, DeviceOp]:
    """One grid of background flow: `(state, books) -> (state', ops)`.

    `books` is the frame-start `[S, ...]` stacked BookState the placement
    model quotes against (best bid/ask per lane; cancel targets gathered
    from resting slots) — the caller applies the returned `[S, T]` grid to
    those books afterwards (each bin owns one grid column, so bin order is
    arrival order and cells never collide). ``draws`` replaces the grid's
    random numbers (``draw_bins``'s layout); the generator state is then
    carried over unchanged. Pure: the same inputs give the same grid."""
    new_state, ops, _ = _gen(config, state, books, draws)
    return new_state, ops


#: The reference's compiled entry; the port has no jit, so it is gen_ops.
gen_ops_jit = gen_ops
