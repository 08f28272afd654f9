"""Plugin lifecycle + control-loop executor (L1 runtime of SURVEY.md §1).

Re-designs the XCM plugin runtime slice the reference relies on: virtual
hooks ``init_control_plugin / on_start / control_loop / close``
(/root/reference/include/QPPVM_RT_plugin/QPPVMPlugin.h:43-46,
/root/reference/include/ForceAccPlugin/ForceAcc.h:41-53), plugin
registration (REGISTER_XBOT_PLUGIN, QPPVMPlugin.cpp:29), and the periodic RT
executor. The Python executor drives jitted control steps against any robot
backend (sim or hardware bridge); the C++ RT executor in ``native/`` provides
hard pacing + latency accounting for deployment.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from qppvm_tpu.runtime.logger import TraceBuffer, get_logger

_PLUGIN_REGISTRY: Dict[str, type] = {}


def register_plugin(name: str):
    """REGISTER_XBOT_PLUGIN analog (/root/reference/src/QPPVMPlugin.cpp:29)."""
    def deco(cls):
        _PLUGIN_REGISTRY[name] = cls
        return cls
    return deco


def get_plugin(name: str) -> type:
    return _PLUGIN_REGISTRY[name]


def registered_plugins():
    return dict(_PLUGIN_REGISTRY)


@dataclasses.dataclass
class Handle:
    """What init_control_plugin receives (robot, config path, shared memory —
    /root/reference/src/ForceAcc.cpp:33,43,52)."""

    robot: Any
    config_path: Optional[str] = None
    shared_memory: Any = None


@dataclasses.dataclass
class LoopStats:
    """Step-latency accounting vs the 1 ms RT budget (the analog of the
    Xenomai deadline, SURVEY.md §2b C22)."""

    latencies_s: np.ndarray
    # Reference failure semantics accounting: every solver failure is
    # counted; under the "skip_actuation" policy each one also skips the
    # command (holds the previous drive reference),
    # /root/reference/src/ForceAcc.cpp:189-193.
    solver_failures: int = 0
    skipped_actuations: int = 0

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.latencies_s, 50) * 1e3)

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.latencies_s, 99) * 1e3)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.latencies_s) * 1e3)

    def deadline_misses(self, budget_s: float = 1e-3) -> int:
        return int(np.sum(self.latencies_s > budget_s))


class ControlLoop:
    """Periodic executor: sense -> control -> actuate, with trace logging and
    latency stats. ``realtime=False`` free-runs (sim-speed); True paces to
    the period like the RT thread."""

    def __init__(self, plugin, robot, *, period: float = 1e-3,
                 trace: Optional[TraceBuffer] = None, realtime: bool = False,
                 ref_generator: Optional[Callable[[float, Dict], Dict]] = None):
        self.plugin = plugin
        self.robot = robot
        self.period = period
        self.trace = trace
        self.realtime = realtime
        self.ref_generator = ref_generator
        self.log = get_logger("control_loop")
        self._closed = False

    def close(self) -> None:
        """Teardown parity with the reference's ``close()`` hook: call the
        plugin's close (if it defines one) and flush the trace buffer —
        the reference flushes its MatLogger exactly here
        (/root/reference/src/QPPVMPlugin.cpp:339-342). Idempotent."""
        if self._closed:
            return
        self._closed = True
        plugin_close = getattr(self.plugin, "close", None)
        if callable(plugin_close):
            plugin_close()
        if self.trace is not None:
            path = self.trace.flush()
            self.log.info("trace flushed to %s", path)

    def run(self, seconds: float, close_on_exit: bool = True) -> LoopStats:
        """Run the loop for ``seconds``; on exit (normal or exceptional)
        invoke :meth:`close` unless ``close_on_exit=False`` (callers that
        run multiple segments against one loop close explicitly)."""
        try:
            return self._run(seconds)
        finally:
            if close_on_exit:
                self.close()

    def _run(self, seconds: float) -> LoopStats:
        robot = self.robot
        plugin = self.plugin
        state = robot.state
        refs, warm, start_ctx = plugin.on_start(state)
        n = int(round(seconds / self.period))
        lat = np.zeros(n)
        n_failures = 0
        n_skipped = 0
        # Failure policy, declared by the plugin (defaults to the reference's
        # ForceAcc behavior):
        #  - "skip_actuation": on solver failure do NOT command; the drives
        #    hold the previously commanded reference
        #    (/root/reference/src/ForceAcc.cpp:189-193 error-returns before
        #    setReferenceFrom/move).
        #  - "command": always command what the plugin produced; QPPVM zeroes
        #    tau_qp itself and still adds h, so the commanded torque falls
        #    back to pure gravity compensation
        #    (/root/reference/src/QPPVMPlugin.cpp:246-256).
        policy = getattr(plugin, "failure_policy", "skip_actuation")
        for i in range(n):
            t = i * self.period
            t0 = time.perf_counter()
            state = robot.state
            refs_t = (self.ref_generator(t, {"refs": refs, "start": start_ctx})
                      if self.ref_generator else refs)
            tau, warm, aux = plugin.control_loop(state, refs_t, warm)
            tau.block_until_ready()
            lat[i] = time.perf_counter() - t0

            failed = bool(aux.solver_failed)
            if failed:
                n_failures += 1
                self.log.error("SOLVER ERROR at t=%.3f", t)  # reference :248
            if failed and policy == "skip_actuation":
                # hold the previous command: no set_reference, no move
                n_skipped += 1
            else:
                robot.set_reference(tau_ref=tau, q_ref=state.q)
                robot.move()

            if self.trace is not None:
                self.trace.add("time_matlogger", t)  # reference :322
                self.trace.add("tau_desired", np.asarray(tau))
                self.trace.add("q", np.asarray(state.q))
                self.trace.add("qd", np.asarray(state.qd))
                self.trace.add("solver_failed", float(failed))

            if self.realtime:
                sleep = self.period - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
        return LoopStats(latencies_s=lat, solver_failures=n_failures,
                         skipped_actuations=n_skipped)
