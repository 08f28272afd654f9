"""Asynchronous plan/act pipeline: act on plan k while plan k+1 computes.

Bridges declared MPC scale and real-time cadence: a
4096-sample planning step takes hundreds of ms on one chip while the WBC
tick runs at 1 kHz, so a deployable loop cannot block on the planner. JAX's
async dispatch IS the pipeline: ``SamplingMPC.plan`` returns device
futures immediately; the control loop keeps acting on the COMMITTED plan
(device arrays from the previous planning round) and commits the in-flight
one only when ``jax.Array.is_ready()`` — never blocking the tick.

Greenfield capability (the reference is a synchronous 1 kHz plugin,
/root/reference/src/QPPVMPlugin.cpp:199-249 — its RT loop has no planner
to overlap). The plan is consumed TIME-SHIFTED: a plan snapshotted at tick
s maps control row ``(tick - s) // ticks_per_step`` to the current tick,
so acting on a one-period-old plan replays the part of the horizon that
corresponds to *now* — the standard latency-compensation trick of async
MPC (plan for tick k+H while acting on plan k).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _is_ready(x) -> bool:
    leaves = jax.tree.leaves(x)
    return all(leaf.is_ready() for leaf in leaves
               if isinstance(leaf, jax.Array))


class AsyncPlanner:
    """Non-blocking MPC wrapper around ``SamplingMPC``.

    Call :meth:`tick` once per control tick. It (a) commits a finished
    in-flight plan, (b) launches a re-plan at the configured cadence when
    the planner is free, and (c) returns the control row of the committed
    plan for *this* tick — all without ever blocking on device results.

    ``replan_ticks``: minimum control ticks between plan launches.
    ``ticks_per_step``: control ticks per plan step (rollout dt / control
    dt), for time-shifted plan consumption.
    """

    def __init__(self, mpc, *, replan_ticks: int, ticks_per_step: int,
                 key: Optional[jax.Array] = None):
        self.mpc = mpc
        self.replan_ticks = int(replan_ticks)
        self.ticks_per_step = int(ticks_per_step)
        self._key = key if key is not None else jax.random.PRNGKey(0)
        self._pending = None         # (U_future, info_future, snap_tick)
        self._committed = None       # (U, snap_tick)
        self._last_launch = None
        # pipeline telemetry (read by tests / operators)
        self.n_launch = 0
        self.n_commit = 0
        self.commit_latency_ticks = []   # launch -> commit tick distances
        self.infos = []                  # committed plan infos (futures ok)

    # ------------------------------------------------------------------
    def tick(self, tick: int, state, refs, warm):
        """Advance the pipeline; returns (u, plan_age_ticks). ``u`` is the
        committed plan's control row for this tick (zeros before the first
        commit), ``plan_age_ticks`` how old the committed plan's state
        snapshot is (-1 before the first commit)."""
        # 1) commit a finished in-flight plan (non-blocking readiness poll)
        if self._pending is not None and _is_ready(self._pending[0]):
            U, info, snap = self._pending
            self._committed = (U, snap)
            self.infos.append(info)
            self.n_commit += 1
            self.commit_latency_ticks.append(tick - snap)
            self._pending = None
        # 2) launch a re-plan if free and due. U_nom seeds from the
        # committed plan so successive plans refine, not restart.
        due = (self._last_launch is None
               or tick - self._last_launch >= self.replan_ticks)
        if self._pending is None and due:
            self._key, k = jax.random.split(self._key)
            U_nom = (self._committed[0] if self._committed is not None
                     else self.mpc.init_plan())
            U_new, info = self.mpc.plan(k, state, refs, warm, U_nom)
            self._pending = (U_new, info, tick)
            self._last_launch = tick
            self.n_launch += 1
        # 3) act on the committed plan, time-shifted to now
        if self._committed is None:
            return jnp.zeros((self.mpc.mppi.nu,), jnp.float32), -1
        U, snap = self._committed
        row = min((tick - snap) // self.ticks_per_step, U.shape[0] - 1)
        return U[row], tick - snap

    def flush(self):
        """Block until the in-flight plan (if any) commits — for orderly
        shutdown/checkpoint, NOT for use inside the control loop."""
        if self._pending is not None:
            jax.block_until_ready(self._pending[0])
            # commit via the normal path at a synthetic tick
            U, info, snap = self._pending
            self._committed = (U, snap)
            self.infos.append(info)
            self.n_commit += 1
            self._pending = None
