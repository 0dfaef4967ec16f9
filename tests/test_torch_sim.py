"""The port's market simulator (gome_tpu_torch.sim) against gome_tpu.sim.

Mirrors tests/test_sim.py on the port (the grid contract, determinism, the
statistical bounds, the environment, the rollout with no host sync, replay
and record mode), then holds the port against the reference with the same
random numbers: torch's generators are not jax.random, so the tests rebuild
the reference's per-bin draws from its own key splits (sim/flow.py's scan
body) and hand them to the port through ``draws=``. Integers must be equal;
the float32 reward, cash and mark to market may differ by the order of
their sums (see ``f32_close``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gome_tpu.engine.book import BookConfig as JBookConfig
from gome_tpu.sim import env as j_env
from gome_tpu.sim import flow as j_flow
from gome_tpu.sim import replay as j_replay
from gome_tpu_torch.engine.book import (
    GRID_I32_FIELDS,
    BookConfig,
    BookState,
    DeviceOp,
    init_books,
)
from gome_tpu_torch.ops import hawkes_scan as k5
from gome_tpu_torch.sim import (
    AgentAction,
    EnvConfig,
    FlowConfig,
    MarketEnv,
    env_reset,
    env_step,
    flow_init,
    gen_ops_jit,
    make_manifest,
    null_action,
    record_frames,
    rollout,
    run_from_manifest,
)
from gome_tpu_torch.sim import env as p_env
from gome_tpu_torch.sim import flow as p_flow
from gome_tpu_torch.sim import replay as p_replay
from gome_tpu_torch.sim import stats as sim_stats
from gome_tpu_torch.sim.replay import env_config_from_manifest

CPU = "cpu"

# A quiet flow for agent-scenario tests: rates so low that background
# events are (astronomically) improbable over a few steps, leaving the
# books entirely to the agent. Rates must be positive by contract.
QUIET = FlowConfig(
    n_lanes=4, t_bins=8, submit_rate=1e-8, cancel_rate=1e-8,
    market_rate=1e-8,
)


def small_env(n_lanes=8, **kw):
    return EnvConfig(
        flow=FlowConfig(n_lanes=n_lanes, t_bins=16),
        book=BookConfig(cap=16, max_fills=4, dtype=torch.int32),
        **kw,
    )


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def leaves(tree) -> list:
    """The tensors of nested (named) tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for item in tree for x in leaves(item)]


# -- the reference's side: configs, draws, state --------------------------------

def j_flow_config(config: FlowConfig):
    import dataclasses

    return j_flow.FlowConfig(**dataclasses.asdict(config))


def j_env_config(config: EnvConfig):
    return j_env.EnvConfig(
        flow=j_flow_config(config.flow),
        book=JBookConfig(
            cap=config.book.cap, max_fills=config.book.max_fills,
            dtype=jnp.int32 if config.book.dtype == torch.int32 else jnp.int64,
        ),
        n_agent_ops=config.n_agent_ops, obs_levels=config.obs_levels,
        agent_uid=config.agent_uid,
    )


def _j_draws_impl(config, key):
    """The reference's per-bin draws of one grid from `key`, split exactly
    as sim/flow.py::_bin_events splits it; jax.random.categorical is
    argmax(gumbel(key, (6,)) + logits), so the type draw is that Gumbel
    noise."""
    zipf = j_flow._zipf_logits(config)

    def body(key, _):
        key, k_ev, k_ty, k_ln, k_pr, k_cx, k_vol, k_uid = jax.random.split(
            key, 8)
        return key, (
            jax.random.uniform(k_ev, (), jnp.float32),
            jax.random.gumbel(k_ty, (6,), jnp.float32),
            jax.random.categorical(k_ln, zipf).astype(jnp.int32),
            jax.random.uniform(k_pr, (), jnp.float32),
            jax.random.uniform(k_cx, (), jnp.float32),
            jax.random.randint(k_vol, (), 1, config.vol_max + 1, jnp.int32),
            jax.random.randint(k_uid, (), 1, config.n_uids + 1, jnp.int32),
        )

    return jax.lax.scan(body, key, None, length=config.t_bins)[1]


_j_draws = jax.jit(_j_draws_impl, static_argnums=0)
_j_bin_events = jax.jit(j_flow._bin_events, static_argnums=0)


def port_draws(config: FlowConfig, key) -> p_flow.Draws:
    """The reference's draws for the grid its state's `key` generates, as
    the port's Draws (CPU tensors)."""
    leaves = jax.device_get(_j_draws(j_flow_config(config), key))
    return p_flow.Draws(*(torch.from_numpy(np.array(x)) for x in leaves))


def j_action(act: dict, dtype):
    return j_env.AgentAction(**{
        k: jnp.asarray(v, jnp.int32 if k in ("lane", "action", "side",
                                             "is_market") else dtype)
        for k, v in act.items()
    })


def p_action(act: dict, dtype):
    return AgentAction(**{
        k: torch.tensor(v, dtype=torch.int32 if k in (
            "lane", "action", "side", "is_market") else dtype)
        for k, v in act.items()
    })


def f32_close(port, ref, scale) -> None:
    """float32 values summed in another order than the reference's: each
    reordered sum may differ by a few ulps of its largest partial sum, so
    the bound is 32 ulps (2**-18) of `scale`, the largest magnitude among
    the step's cash, mark to market and inventory value."""
    tol = 2.0 ** -18 * max(float(scale), 1.0)
    assert abs(float(port) - float(ref)) <= tol, (float(port), float(ref), tol)


def assert_books_equal(p_books: BookState, j_books) -> None:
    for name in BookState._fields:
        np.testing.assert_array_equal(
            host(getattr(p_books, name)),
            np.asarray(getattr(j_books, name)), err_msg=name)


def assert_step_equal(p_out, j_out) -> None:
    """Books, Obs and StepInfo equal (lam within the stated tolerance: none,
    see test_hawkes_scan_matches_reference); reward, cash and mark to
    market within f32_close."""
    p_state, p_obs, p_reward, p_info = p_out
    j_state, j_obs, j_reward, j_info = jax.device_get(j_out)
    assert_books_equal(p_state.books, j_state.books)
    for name in p_env.Obs._fields:
        np.testing.assert_array_equal(
            host(getattr(p_obs, name)), np.asarray(getattr(j_obs, name)),
            err_msg=f"obs.{name}")
    for name in p_env.StepInfo._fields:
        np.testing.assert_array_equal(
            host(getattr(p_info, name)), np.asarray(getattr(j_info, name)),
            err_msg=f"info.{name}")
    np.testing.assert_array_equal(host(p_state.inv), np.asarray(j_state.inv))
    for name in ("t", "next_oid"):
        src = p_state if name == "t" else p_state.flow
        ref = j_state if name == "t" else j_state.flow
        assert int(getattr(src, name)) == int(getattr(ref, name)), name
    scale = max(abs(float(j_state.cash)), abs(float(j_state.mtm)),
                float(np.abs(np.asarray(j_state.inv, np.float64)
                             * np.asarray(j_obs.mid, np.float64)).sum()))
    f32_close(p_state.cash, j_state.cash, scale)
    f32_close(p_state.mtm, j_state.mtm, scale)
    f32_close(p_reward, j_reward, scale)


def j_state_after(config: EnvConfig, seed: int, n_steps: int):
    """The reference's env state after n_steps of background flow."""
    jc = j_env_config(config)
    state, _ = j_env.env_reset(jc, jax.random.PRNGKey(seed))
    nop = j_env.null_action(jc)
    for _ in range(n_steps):
        state, *_ = j_env.env_step(jc, state, nop)
    return state


# -- flow: grid contract ------------------------------------------------------

class TestFlowGrid:
    def test_grid_layout_and_dtypes(self):
        config = FlowConfig(n_lanes=8, t_bins=32)
        books = init_books(BookConfig(cap=8, max_fills=2, dtype=torch.int32),
                           8, CPU)
        state = flow_init(config, 0, CPU)
        state2, ops = gen_ops_jit(config, state, books)
        assert isinstance(ops, DeviceOp)
        for f in DeviceOp._fields:
            leaf = getattr(ops, f)
            assert tuple(leaf.shape) == (8, 32), f
            assert leaf.dtype == torch.int32, f
        h = {f: host(getattr(ops, f)) for f in DeviceOp._fields}
        assert set(np.unique(h["action"])) <= {0, 1, 2}
        # Each bin owns one grid column: at most one event per column.
        assert ((h["action"] != 0).sum(axis=0) <= 1).all()
        occupied = h["action"] != 0
        # NOP cells are fully zeroed (inert anywhere in the grid).
        for f in DeviceOp._fields:
            assert (h[f][~occupied] == 0).all(), f
        # DELs carry volume 0; markets price 0; ADD prices >= 1.
        adds = h["action"] == 1
        dels = h["action"] == 2
        assert (h["volume"][dels] == 0).all()
        assert (h["volume"][adds] >= 1).all()
        mkts = h["is_market"] == 1
        assert (h["price"][mkts & adds] == 0).all()
        assert (h["price"][adds & ~mkts] >= 1).all()
        # The intensity state advanced.
        assert int(state2.next_oid) >= 1
        assert float(state2.t_model) > 0

    def test_grid_i64_book_dtype(self):
        config = FlowConfig(n_lanes=4, t_bins=8)
        books = init_books(BookConfig(cap=8, max_fills=2, dtype=torch.int64),
                           4, CPU)
        state = flow_init(config, 1, CPU)
        _, ops = gen_ops_jit(config, state, books)
        for f in DeviceOp._fields:
            want = torch.int32 if f in GRID_I32_FIELDS else torch.int64
            assert getattr(ops, f).dtype == want, f

    def test_deterministic_in_seed(self):
        config = FlowConfig(n_lanes=8, t_bins=32)
        books = init_books(BookConfig(cap=8, max_fills=2, dtype=torch.int32),
                           8, CPU)

        def run():
            state = flow_init(config, 7, CPU)
            return gen_ops_jit(config, state, books)[1]

        a, b = run(), run()
        for f in DeviceOp._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f

    def test_unstable_hawkes_raises(self):
        with pytest.raises(ValueError, match="unstable"):
            FlowConfig(excite_self=0.9, excite_cross=0.2)

    def test_saturated_discretization_raises(self):
        with pytest.raises(ValueError, match="saturates"):
            FlowConfig(dt=0.5)


# -- flow: statistical validation ---------------------------------------------

class TestFlowStats:
    @pytest.fixture(scope="class")
    def sample(self):
        config = FlowConfig(n_lanes=32, t_bins=64)
        return config, sim_stats.sample_grids(config, 0, 300, device=CPU)

    def test_zipf_exponent(self, sample):
        config, s = sample
        fit = sim_stats.zipf_exponent(sim_stats.symbol_counts(s))
        assert abs(fit - config.zipf_a) < 0.3, fit

    def test_hawkes_branching_and_clustering(self, sample):
        config, s = sample
        per_grid = sim_stats.events_per_grid(s)
        n_hat = sim_stats.empirical_branching_ratio(
            config, int(per_grid.sum()), len(per_grid)
        )
        assert 0.25 < n_hat < config.branching_ratio() + 0.05, n_hat
        assert sim_stats.dispersion_index(per_grid) > 1.2

    def test_poisson_limit(self):
        config = FlowConfig(
            n_lanes=32, t_bins=64, excite_self=1e-6, excite_cross=1e-6,
            excite_kind=1e-6,
        )
        s = sim_stats.sample_grids(config, 1, 300, device=CPU)
        per_grid = sim_stats.events_per_grid(s)
        assert abs(sim_stats.dispersion_index(per_grid) - 1.0) < 0.25
        n_hat = sim_stats.empirical_branching_ratio(
            config, int(per_grid.sum()), len(per_grid)
        )
        assert abs(n_hat) < 0.12, n_hat


# -- env: reset/step/rollout --------------------------------------------------

def agent(**kw):
    z = [0, 0]
    base = dict(lane=z, action=z, side=z, is_market=z, price=z, volume=z,
                oid=z)
    base.update(kw)
    return base


class TestEnv:
    def test_reset_step_shapes(self):
        config = small_env()
        s, e, ell = 8, 6, config.obs_levels
        state, obs = env_reset(config, 0, CPU)
        assert tuple(obs.best_bid.shape) == (s,)
        assert tuple(obs.bid_prices.shape) == (s, ell)
        assert tuple(obs.counts.shape) == (s, 2)
        assert obs.counts.dtype == torch.int32
        assert tuple(obs.mid.shape) == (s,) and obs.mid.dtype == torch.float32
        assert tuple(obs.lam.shape) == (e,) and obs.lam.dtype == torch.float32
        state2, obs2, reward, info = env_step(
            config, state, null_action(config, CPU)
        )
        assert tuple(reward.shape) == () and reward.dtype == torch.float32
        assert info.trades.dtype == torch.int32
        assert tuple(info.checksum.shape) == (4,)
        assert int(state2.t) == 1
        assert tuple(state2.inv.shape) == (s,)

    def test_rollout_trajectory(self):
        config = small_env()
        state, _ = env_reset(config, 2, CPU)
        final, (rewards, info) = rollout(config, state, 20)
        assert tuple(rewards.shape) == (20,)
        assert tuple(info.events.shape) == (20,)
        assert int(final.t) == 20
        assert int(info.events.sum()) > 0

    def test_market_env_wrapper(self):
        env = MarketEnv(small_env(), device=CPU)
        state, obs = env.reset(0)
        state, obs, reward, info = env.step(state, env.null_action())
        assert int(state.t) == 1

    def test_agent_maker_taker_pnl(self):
        # Background silenced: the agent trades against itself on lane 1
        # — rest a bid, lift it with a market sale, then cancel the rest.
        config = EnvConfig(
            flow=QUIET, book=BookConfig(cap=8, max_fills=4, dtype=torch.int32),
            n_agent_ops=2,
        )
        state, obs = env_reset(config, 0, CPU)
        oid = 1 << 24  # agent handles live above background oids
        act = lambda **kw: p_action(agent(**kw), torch.int32)
        state, obs, reward, info = env_step(config, state, act(
            lane=[1, 0], action=[1, 0], side=[0, 0], price=[100, 0],
            volume=[5, 0], oid=[oid, 0]))
        assert int(obs.best_bid[1]) == 100
        assert int(obs.counts[1, 0]) == 1
        assert int(info.trades) == 0
        state, obs, reward, info = env_step(config, state, act(
            lane=[1, 0], action=[1, 0], side=[1, 0], is_market=[1, 0],
            volume=[2, 0], oid=[oid + 1, 0]))
        assert int(info.trades) == 1
        assert int(info.traded_qty) == 2
        assert int(info.agent_fills) == 2  # maker AND taker records
        # Self-trade: maker +2, taker -2 inventory; cash nets to zero.
        assert int(state.inv[1]) == 0
        assert float(state.cash) == pytest.approx(0.0)
        assert int(obs.bid_lots[1, 0]) == 3  # 5 rested - 2 filled
        state, obs, reward, info = env_step(config, state, act(
            lane=[1, 0], action=[2, 0], side=[0, 0], price=[100, 0],
            oid=[oid, 0]))
        assert int(info.cancels_missed) == 0
        assert int(obs.counts[1, 0]) == 0

    def test_env_config_validation(self):
        with pytest.raises(ValueError, match="agent_uid"):
            EnvConfig(flow=FlowConfig(n_lanes=4), agent_uid=8)
        with pytest.raises(ValueError, match="obs_levels"):
            EnvConfig(
                book=BookConfig(cap=4, max_fills=2, dtype=torch.int32),
                obs_levels=9,
            )

    def test_env_step_is_pure(self):
        # The generator's state rides in the EnvState: two steps from one
        # state give one result (a shared generator would advance).
        config = small_env()
        state, _ = env_reset(config, 4, CPU)
        state, *_ = rollout(config, state, 3)
        act = p_action(agent(lane=[2, 0], action=[1, 0], price=[100_010, 0],
                             volume=[7, 0], oid=[1 << 24, 0]), torch.int32)
        a = env_step(config, state, act)
        b = env_step(config, state, act)
        for x, y in zip(leaves(a), leaves(b)):
            assert torch.equal(x, y)


# -- the rollout reads nothing back to the host -------------------------------

class HostRead(AssertionError):
    pass


class no_host_reads:
    """Every way a tensor reaches the host (item, int/float/bool/index,
    tolist, numpy, nonzero) raises inside the block: the CPU counterpart of
    torch.cuda.set_sync_debug_mode("error") on the card. K1's plain version
    reads which grid columns are live (it skips NOP columns); the kernel
    it stands for on the card does not, so the guard is lifted inside it."""

    NAMES = ("item", "__int__", "__float__", "__bool__", "__index__",
             "tolist", "numpy", "nonzero")

    def __enter__(self):
        from gome_tpu_torch.ops import match_step

        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        self.step = match_step.batch_step

        def refuse(name):
            def read(*a, **kw):
                raise HostRead(f"Tensor.{name} inside a rollout")
            return read

        def kernel(*args):
            self.lift()
            try:
                return self.step(*args)
            finally:
                self.arm()

        self.refusals = {n: refuse(n) for n in self.NAMES}
        self.arm()
        match_step.batch_step = kernel
        return self

    def arm(self):
        for n, f in self.refusals.items():
            setattr(torch.Tensor, n, f)

    def lift(self):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)

    def __exit__(self, *exc):
        from gome_tpu_torch.ops import match_step

        self.lift()
        match_step.batch_step = self.step
        return False


class TestNoHostSyncRollout:
    CONFIG = EnvConfig(
        flow=FlowConfig(n_lanes=256),
        book=BookConfig(cap=32, max_fills=8, dtype=torch.int32),
    )

    def test_rollout_1000_steps_no_host_reads(self):
        config = self.CONFIG
        state, _ = env_reset(config, 3, CPU)
        with no_host_reads():
            final, (rewards, info) = rollout(config, state, 1000)
        ev, tr = host(info.events), host(info.trades)
        assert ev.shape == (1000,)
        assert int(ev.sum()) > 1000  # flow actually ran
        assert int(tr.sum()) > 100  # and actually traded
        # Exactness: geometry absorbs the whole flow (no silent drops).
        assert int(info.book_overflow.sum()) == 0
        assert int(info.fill_overflow.sum()) == 0

    def test_guard_catches_a_host_read(self):
        config = small_env()
        state, _ = env_reset(config, 0, CPU)
        with no_host_reads():
            rollout(config, state, 2)
            with pytest.raises(HostRead):
                int(state.t)
        assert int(state.t) == 0  # the guard is gone


# -- replay: manifests, two-process bit-exactness, GCO record mode ------------

REPLAY_CONFIG = EnvConfig(
    flow=FlowConfig(n_lanes=16, t_bins=32),
    book=BookConfig(cap=16, max_fills=4, dtype=torch.int32),
)

_REPLAY_CHILD = """
import json, sys
from gome_tpu_torch.sim import run_from_manifest
print(json.dumps(run_from_manifest(json.load(open(sys.argv[1])), "cpu")))
"""


class TestReplay:
    def test_manifest_roundtrip(self):
        m = make_manifest(REPLAY_CONFIG, seed=9, n_steps=12)
        blob = json.loads(json.dumps(m))
        assert env_config_from_manifest(blob) == REPLAY_CONFIG

    def test_manifest_hash_mismatch_raises(self):
        m = make_manifest(REPLAY_CONFIG, seed=9, n_steps=12)
        m = json.loads(json.dumps(m))
        m["config"]["flow"]["zipf_a"] = 1.3  # hand-edited
        with pytest.raises(ValueError, match="hash mismatch"):
            env_config_from_manifest(m)
        m2 = make_manifest(REPLAY_CONFIG, seed=9, n_steps=12)
        m2["version"] = 99
        with pytest.raises(ValueError, match="version"):
            env_config_from_manifest(m2)

    def test_two_process_bit_exact_replay(self, tmp_path):
        manifest = make_manifest(REPLAY_CONFIG, seed=41, n_steps=40)
        here = run_from_manifest(manifest, CPU)
        assert here["events"] > 0
        path = tmp_path / "manifest.json"
        path.write_text(json.dumps(manifest))
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            [sys.executable, "-c", _REPLAY_CHILD, str(path)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=root),
        )
        assert out.returncode == 0, out.stderr[-2000:]
        there = json.loads(out.stdout.strip().splitlines()[-1])
        assert there == here

    def test_in_process_replay_deterministic(self):
        manifest = make_manifest(REPLAY_CONFIG, seed=5, n_steps=25)
        assert run_from_manifest(manifest, CPU) == run_from_manifest(
            manifest, CPU)
        other = run_from_manifest(
            make_manifest(REPLAY_CONFIG, seed=6, n_steps=25), CPU)
        assert other["digest"] != run_from_manifest(manifest, CPU)["digest"]

    def test_record_frames_feed_service_codec(self):
        from gome_tpu_torch.bus.colwire import decode_order_frame
        from gome_tpu_torch.engine import MatchEngine
        from gome_tpu_torch.engine.frames import orders_from_frame

        config = EnvConfig(
            flow=FlowConfig(n_lanes=8, t_bins=32),
            book=BookConfig(cap=16, max_fills=4, dtype=torch.int32),
        )
        frames = record_frames(config, seed=2, n_steps=10, device=CPU)
        assert frames, "flow produced no frames in 10 steps"
        engine = MatchEngine(
            BookConfig(cap=32, max_fills=8, dtype=torch.int32),
            n_slots=8, max_t=16, device=CPU,
        )
        n_orders = n_events = 0
        for payload in frames:
            orders = orders_from_frame(decode_order_frame(payload))
            n_orders += len(orders)
            n_events += len(engine.process(orders))
        assert n_orders > 0
        engine.batch.verify_books()

    def test_bin_columns_equal_grid_columns(self):
        config = EnvConfig(
            flow=FlowConfig(n_lanes=8, t_bins=64),
            book=BookConfig(cap=16, max_fills=4, dtype=torch.int64),
        )
        state, _ = env_reset(config, 6, CPU)
        seen = 0
        for _ in range(6):
            state, ops, _info, bins = p_replay._record_step(config, state)
            for drop in (False, True):
                a = p_replay.grid_to_columns(p_replay.grid_host(ops), drop)
                b = p_replay.bin_columns(bins, drop)
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            seen += a["n"]
        assert seen > 0


# -- the port against gome_tpu, given the same draws ---------------------------

def test_hawkes_scan_matches_reference():
    """hawkes_scan_reference against the reference's _bin_events over 50
    chained grids at 8 lanes x 32 bins, with the reference's draws: equal
    occur, etype, oid, lane and next_oid, and the intensities bit-equal."""
    config = FlowConfig(n_lanes=8, t_bins=32)
    jc = j_flow_config(config)
    lam_j = jnp.asarray(config.mu(), jnp.float32)
    oid_j = jnp.ones((), jnp.int32)
    lam_p = torch.tensor(config.mu(), dtype=torch.float32)
    oid_p = torch.ones((), dtype=torch.int32)
    key = jax.random.PRNGKey(11)
    events = 0
    for _ in range(50):
        d = port_draws(config, key)
        (lam_j, key2, oid_j), outs = _j_bin_events(jc, lam_j, key, oid_j)
        occur, etype, lane, _uid, oid_here = jax.device_get(outs[:5])
        scan = k5.hawkes_scan(config, lam_p, oid_p, d.u_ev, d.g_ty)
        np.testing.assert_array_equal(host(scan.occur), occur)
        np.testing.assert_array_equal(host(scan.etype), etype)
        np.testing.assert_array_equal(host(scan.oid), oid_here)
        np.testing.assert_array_equal(host(d.lane), lane)
        np.testing.assert_array_equal(host(scan.lam), np.asarray(lam_j))
        assert int(scan.next_oid) == int(oid_j)
        lam_p, oid_p, key = scan.lam, scan.next_oid, key2
        events += int(occur.sum())
    assert events > 100


def test_hawkes_scan_wrapper_checks_its_inputs():
    config = FlowConfig()
    lam = torch.tensor(config.mu(), dtype=torch.float32)
    oid = torch.ones((), dtype=torch.int32)
    u = torch.rand(4)
    g = torch.rand(4, 6)
    k5.hawkes_scan(config, lam, oid, u, g)
    with pytest.raises(ValueError, match="dtype"):
        k5.hawkes_scan(config, lam.double(), oid, u, g)
    with pytest.raises(ValueError, match="shape"):
        k5.hawkes_scan(config, lam, oid, u, g[:3])
    with pytest.raises(ValueError, match="contiguous"):
        k5.hawkes_scan(config, lam, oid, u, torch.rand(6, 4).T)
    with pytest.raises(ValueError, match="non-empty"):
        k5.hawkes_scan(config, lam, oid, u[:0], g[:0])


@pytest.mark.parametrize("name", chip_smoke.HAWKES_EDGE_CASES)
def test_hawkes_edge_inputs_hit_what_they_name(name):
    """chip_smoke's K5 edge inputs (held against the kernel on the card)
    through the plain version on the CPU: each hits what it names, and the
    order ids advance by one after each ADD."""
    config = FlowConfig()
    lam, oid0, u_ev, g_ty = chip_smoke.hawkes_edge_case(config, name, CPU)
    out = k5.hawkes_scan_reference(config, lam, oid0, u_ev, g_ty)
    occ, ety = host(out.occur), host(out.etype)
    assert np.isfinite(host(out.lam)).all()
    adds = occ & (ety // 2 != 1)
    np.testing.assert_array_equal(
        host(out.oid), 1 + np.concatenate([[0], np.cumsum(adds)[:-1]]))
    assert int(out.next_oid) == 1 + int(adds.sum())
    if name == "event_every_bin":
        assert occ.all()
    elif name == "no_event":
        assert not occ.any()
    elif name == "u_equals_p":
        # u_ev is p_event itself, so the strict u < p never holds; one ulp
        # lower and the first bin has its event
        assert not occ.any()
        below = torch.nextafter(u_ev, torch.zeros_like(u_ev))
        first = k5.hawkes_scan_reference(config, lam, oid0, below, g_ty)
        assert int(first.occur[0]) == 1
    elif name == "tied_maxima":
        assert not occ.any()
        want = np.resize(np.asarray(chip_smoke.HAWKES_TIE_ETYPES), len(ety))
        np.testing.assert_array_equal(ety, want)
        score = g_ty[:4] + torch.log(lam + k5.EPS)
        for row, e in zip(score, chip_smoke.HAWKES_TIE_ETYPES):
            assert row[e] == row[e + 1] == row.max()  # a tie, the first kept
    elif name == "zero_intensity":
        zeros = list(chip_smoke.HAWKES_ZERO_TYPES)
        assert (host(lam)[zeros] == 0).all()
        assert ety[0] not in zeros
    elif name == "partial_last_round":
        assert not occ.any() and len(occ) == 1027
    else:
        assert len(occ) == int(name[1:])


def test_hawkes_bounds_on_a_fixed_probe():
    """K5's bound arithmetic (chip_smoke) on fixed probe latencies: the
    chain without speculation, the floor that no design removes (an
    event-free update of lam, whatever the pick costs, and no larger than
    that chain), and the bytes term."""
    lat = dict(add=4.89, log=91.88, exp=46.75, cs=14.87, shfl=26.01,
               ballot=18.38, lds=29.0, update=9.26)
    chain = chip_smoke.hawkes_chain_cycles(lat)
    assert chain == pytest.approx(
        max(91.88 + 4.89 + 3 * 14.87, 6 * 4.89 + 46.75) + 14.87 + 4.89)
    spec = chip_smoke.hawkes_spec_cycles(lat)
    assert spec == 9.26 and spec <= chain
    cheap_picks = dict(lat, cs=1.0, shfl=1.0, ballot=1.0, lds=1.0)
    assert chip_smoke.hawkes_spec_cycles(cheap_picks) == 9.26
    for t_bins in (1, 32, 1024, 65536):
        by_bytes = (t_bins * (4 + 6 * 4 + 3 * 4) + 2 * 6 * 4 + 2 * 4) / 3.35e12
        bound, _ = chip_smoke.hawkes_bound_ms(t_bins, spec)
        assert bound == pytest.approx(
            1e3 * max(by_bytes, t_bins * spec / 1.98e9))
        assert bound <= chip_smoke.hawkes_bound_ms(t_bins, chain)[0]
    assert chip_smoke.hawkes_bound_ms(1024, 1e-3) == pytest.approx(
        ((1024 * 40 + 56) / 3.35e12 * 1e3, "bytes"))


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_gen_ops_matches_reference_given_its_draws(dtype):
    """gen_ops with the reference's draws against the reference's gen_ops,
    on books after a few steps (so cancels hit resting orders): every grid
    leaf, the intensities and the order-id counter equal."""
    tdt = torch.int32 if dtype == "int32" else torch.int64
    config = EnvConfig(flow=FlowConfig(n_lanes=8, t_bins=32),
                       book=BookConfig(cap=16, max_fills=4, dtype=tdt))
    jc = j_env_config(config)
    j_state = j_state_after(config, 13, 4)
    p_state = p_env.env_state_from_numpy(config, jax.device_get(j_state), 0,
                                         CPU)
    hits = 0
    for _ in range(4):
        draws = port_draws(config.flow, j_state.flow.key)
        j_flow2, j_ops = j_flow.gen_ops_jit(jc.flow, j_state.flow,
                                            j_state.books)
        p_flow2, p_ops = p_flow.gen_ops(config.flow, p_state.flow,
                                        p_state.books, draws=draws)
        j_ops = jax.device_get(j_ops)
        for f in DeviceOp._fields:
            got = getattr(p_ops, f)
            want = torch.int32 if f in GRID_I32_FIELDS else tdt
            assert got.dtype == want, f
            np.testing.assert_array_equal(host(got), getattr(j_ops, f),
                                          err_msg=f)
        np.testing.assert_array_equal(host(p_flow2.lam),
                                      np.asarray(j_flow2.lam))
        assert int(p_flow2.next_oid) == int(j_flow2.next_oid)
        hits += int(((j_ops.action == 2) & (j_ops.oid != 0)).sum())
        # Both apply the same grid before the next one.
        j_state, *_ = j_env.env_step(jc, j_state, j_env.null_action(jc))
        p_state, *_ = env_step(config, p_state, null_action(config, CPU),
                               draws=draws)
    assert hits > 0


def scripted_agent(step: int, obs, config: EnvConfig, prices: dict) -> dict:
    """A market maker and taker on lanes step % S: slot 0 rests a bid one
    tick above the best bid (or takes the ask every third step), slot 1
    cancels the bid rested two steps before (a miss when it filled).
    `prices` holds each step's slot-0 price for the later cancel."""
    s = config.flow.n_lanes
    lane = step % s
    oid = (1 << 24) + step
    bid = int(obs.best_bid[lane]) or config.flow.ref_price - 5
    ask = int(obs.best_ask[lane]) or config.flow.ref_price + 5
    if step % 3 == 2:
        slot0 = dict(side=1 if step % 2 else 0, is_market=1, price=0,
                     volume=3)
    else:
        slot0 = dict(side=0, is_market=0, price=min(bid + 1, ask - 1),
                     volume=4)
    prev = step - 2
    act = agent(
        lane=[lane, prev % s], action=[1, 2 if prev >= 0 else 0],
        side=[slot0["side"], 0], is_market=[slot0["is_market"], 0],
        price=[slot0["price"], prices.get(prev, 0)],
        volume=[slot0["volume"], 0], oid=[oid, (1 << 24) + prev],
    )
    prices[step] = slot0["price"]
    return act


def test_env_step_matches_reference_over_30_steps():
    """30 env_steps from a reference state carried by env_state_from_numpy,
    with the reference's background draws and a scripted agent: equal
    books, Obs and StepInfo at every step; reward, cash and mark to market
    within f32_close."""
    config = EnvConfig(flow=FlowConfig(n_lanes=8, t_bins=32),
                       book=BookConfig(cap=32, max_fills=8,
                                       dtype=torch.int32))
    jc = j_env_config(config)
    j_state = j_state_after(config, 21, 5)
    p_state = p_env.env_state_from_numpy(config, jax.device_get(j_state), 0,
                                         CPU)
    j_obs = j_env._observe(jc, j_state.books, j_state.flow, j_state.t)
    prices, agent_fills = {}, 0
    for step in range(30):
        act = scripted_agent(step, jax.device_get(j_obs), config, prices)
        draws = port_draws(config.flow, j_state.flow.key)
        j_out = j_env.env_step(jc, j_state, j_action(act, jnp.int32))
        p_out = env_step(config, p_state, p_action(act, torch.int32),
                         draws=draws)
        assert_step_equal(p_out, j_out)
        j_state, j_obs = j_out[0], j_out[1]
        p_state = p_out[0]
        agent_fills += int(p_out[3].agent_fills)
    assert agent_fills > 0


def test_out_of_range_agent_lanes_match_reference():
    """Agent lanes -1 (the last lane), S and -S-1 (dropped by the
    reference's scatter, clamped by its gathers), in both packages."""
    config = EnvConfig(flow=QUIET, book=BookConfig(cap=8, max_fills=4,
                                                   dtype=torch.int32),
                       n_agent_ops=4)
    jc = j_env_config(config)
    s = config.flow.n_lanes
    j_state, _ = j_env.env_reset(jc, jax.random.PRNGKey(0))
    p_state = p_env.env_state_from_numpy(config, jax.device_get(j_state), 0,
                                         CPU)
    rest = dict(lane=[-1, s, -s - 1, 0], action=[1, 1, 1, 1],
                side=[1, 1, 1, 1], is_market=[0, 0, 0, 0],
                price=[100, 100, 100, 100], volume=[5, 5, 5, 5],
                oid=[1 << 24, (1 << 24) + 1, (1 << 24) + 2, (1 << 24) + 3])
    take = dict(lane=[-1, s, 0, -s - 1], action=[1, 1, 1, 1],
                side=[0, 0, 0, 0], is_market=[1, 1, 1, 1],
                price=[0, 0, 0, 0], volume=[2, 2, 2, 2],
                oid=[(1 << 24) + 4, (1 << 24) + 5, (1 << 24) + 6,
                     (1 << 24) + 7])
    for act in (rest, take):
        draws = port_draws(config.flow, j_state.flow.key)
        j_out = j_env.env_step(jc, j_state, j_action(act, jnp.int32))
        p_out = env_step(config, p_state, p_action(act, torch.int32),
                         draws=draws)
        assert_step_equal(p_out, j_out)
        j_state, p_state = j_out[0], p_out[0]
    # Lanes -1 (= S-1) and 0 rested 5 and sold 2 to the agent itself (a
    # maker and a taker record each); lanes S and -S-1 did nothing.
    assert int(p_out[3].agent_fills) == 4
    lots = host(p_state.books.lots[:, 1, 0])
    assert lots.tolist() == [3, 0, 0, 3]
    assert host(p_state.inv).tolist() == [0, 0, 0, 0]


def test_int32_sums_wrap_as_reference():
    """int64 books with prices and volumes past 2**31: the checksum, the
    traded lots and the inventory wrap to int32 in both packages alike."""
    config = EnvConfig(flow=QUIET, book=BookConfig(cap=8, max_fills=4,
                                                   dtype=torch.int64))
    jc = j_env_config(config)
    j_state, _ = j_env.env_reset(jc, jax.random.PRNGKey(1))
    p_state = p_env.env_state_from_numpy(config, jax.device_get(j_state), 0,
                                         CPU)
    big = 3_000_000_000
    steps = [
        agent(lane=[2, 2], action=[1, 1], side=[1, 1],
              price=[5_000_000_001, 5_000_000_003], volume=[big, big],
              oid=[1 << 24, (1 << 24) + 1]),
        agent(lane=[2, 0], action=[1, 0], side=[0, 0], is_market=[1, 0],
              volume=[2 * big, 0], oid=[(1 << 24) + 2, 0]),
    ]
    for act in steps:
        draws = port_draws(config.flow, j_state.flow.key)
        j_out = j_env.env_step(jc, j_state, j_action(act, jnp.int64))
        p_out = env_step(config, p_state, p_action(act, torch.int64),
                         draws=draws)
        assert_step_equal(p_out, j_out)
        j_state, p_state = j_out[0], p_out[0]
    info = p_out[3]
    assert int(info.trades) == 2
    # 2 x 3e9 lots: the int32 fold wraps (not the exact 6e9).
    assert int(info.traded_qty) == np.int64(2 * big).astype(np.int32)
    assert int(p_state.inv[2]) == 0  # +6e9 maker, -6e9 taker, wrapped


@pytest.mark.parametrize("writer", ["gome_tpu", "port"])
def test_manifest_loads_in_the_other_package(writer):
    port_cfg = EnvConfig(
        flow=FlowConfig(n_lanes=12, t_bins=24, zipf_a=1.3, vol_max=60),
        book=BookConfig(cap=32, max_fills=8, dtype=torch.int64),
        n_agent_ops=3, obs_levels=5,
    )
    jax_cfg = j_env_config(port_cfg)
    if writer == "port":
        m = json.loads(json.dumps(make_manifest(port_cfg, 3, 7)))
        back = j_replay.env_config_from_manifest(m)
        assert back == jax_cfg
    else:
        m = json.loads(json.dumps(j_replay.make_manifest(jax_cfg, 3, 7)))
        back = env_config_from_manifest(m)
        assert back == port_cfg
    assert p_replay.config_digest(port_cfg) == j_replay.config_digest(
        jax_cfg) == m["config_sha256"]


@pytest.mark.parametrize("kw", [{}, dict(
    n_lanes=64, t_bins=48, zipf_a=1.4, cap=64, max_fills=8, dtype="int64",
    n_agent_ops=3, obs_levels=6, excite_self=0.3, ref_price=5_000)])
def test_sim_config_env_config_matches_reference(kw):
    from gome_tpu.config import SimConfig as JSimConfig
    from gome_tpu_torch.config import SimConfig

    port = SimConfig(**kw).env_config()
    ref = JSimConfig(**kw).env_config()
    assert isinstance(port, EnvConfig)
    assert p_replay.config_dict(port) == j_replay.config_dict(ref)
    assert port == env_config_from_manifest(
        j_replay.make_manifest(ref, 0, 1))


@pytest.mark.parametrize("seed", [1000, 1001, 1002])
def test_oracle_parity_on_simulated_flow(seed):
    """scripts/fuzz.py's run_sim_case on the port: a seeded simulated
    stream (record mode on a generous sim-side geometry) through the port's
    oracle and the port's engine at an adversarial geometry; events equal
    and books verified."""
    from gome_tpu_torch.engine import BatchEngine
    from gome_tpu_torch.oracle import OracleEngine

    rng = np.random.default_rng(seed)
    flow = FlowConfig(
        n_lanes=int(rng.choice([2, 4, 7])),
        t_bins=int(rng.choice([32, 64])),
        excite_self=float(rng.choice([0.25, 0.45])),
        cancel_rate=float(rng.choice([0.8, 1.4, 2.0])),
        market_rate=float(rng.choice([0.2, 0.8])),
        offset_p=float(rng.choice([0.2, 0.5])),
        vol_max=int(rng.choice([5, 60])),
    )
    gen_cfg = EnvConfig(flow=flow, book=BookConfig(cap=64, max_fills=8,
                                                   dtype=torch.int32))
    n_grids = int(rng.choice([8, 20]))
    state, _ = env_reset(gen_cfg, seed, CPU)
    orders = []
    for _ in range(n_grids):
        state, ops, _info, _bins = p_replay._record_step(gen_cfg, state)
        orders.extend(p_replay.orders_from_grid(p_replay.grid_host(ops)))
    oracle = OracleEngine()
    expected = []
    for o in orders:
        expected.extend(oracle.process(o))
    dtype = torch.int32 if rng.random() < 0.5 else torch.int64
    engine = BatchEngine(
        BookConfig(cap=int(rng.choice([4, 8, 16])),
                   max_fills=int(rng.choice([1, 2, 4])), dtype=dtype),
        n_slots=int(rng.choice([1, 2, flow.n_lanes])),
        max_t=int(rng.choice([1, 3, 16])), device=CPU,
    )
    columnar = rng.choice(["object", "columnar"]) == "columnar"
    chunk = int(rng.choice([1, 17, 64]))
    got = []
    for i in range(0, len(orders), chunk):
        part = orders[i:i + chunk]
        got.extend(engine.process_columnar(part).to_results() if columnar
                   else engine.process(part))
    assert len(orders) > 0
    assert got == expected
    engine.verify_books()
