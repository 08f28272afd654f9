"""RT-safe signal logging + severity console logger.

Re-designs XBot::MatLogger (/root/reference/src/QPPVMPlugin.cpp:44,54,254:
preallocated buffers, named channels, flush-to-.mat on close) and
XBot::Logger (/root/reference/src/ForceAcc.cpp:191,203,277). The TraceBuffer
preallocates host arrays (no allocation in the hot loop) and flushes to
``.npz`` and, when scipy is present, MATLAB ``.mat`` for workflow parity.
"""
from __future__ import annotations

import enum
import logging
import sys
import time
from typing import Dict

import numpy as np


class TraceBuffer:
    """Preallocated named-channel signal logger (MatLogger analog).

    >>> log = TraceBuffer("/tmp/qppvm_log", capacity=30000)  # :44,:54
    >>> log.add("tau_qp", tau)                               # :254
    >>> log.tick()          # advance the sample index (once per loop)
    >>> log.flush()         # :341
    """

    def __init__(self, path: str, capacity: int = 30000):
        self.path = path
        self.capacity = capacity
        self._buffers: Dict[str, np.ndarray] = {}
        self._idx: Dict[str, int] = {}

    def add(self, name: str, value) -> None:
        value = np.asarray(value)
        if name not in self._buffers:
            self._buffers[name] = np.zeros((self.capacity,) + value.shape,
                                           dtype=np.float64)
            self._idx[name] = 0
        i = self._idx[name]
        if i < self.capacity:
            self._buffers[name][i] = value
            self._idx[name] = i + 1

    def add_block(self, name: str, block) -> None:
        """Append a (T, ...) block of samples to a channel in one call (the
        chunked device-stream path, ``scan_with_stream``)."""
        block = np.asarray(block)
        if name not in self._buffers:
            self._buffers[name] = np.zeros(
                (self.capacity,) + block.shape[1:], dtype=np.float64)
            self._idx[name] = 0
        i = self._idx[name]
        n = min(block.shape[0], self.capacity - i)
        if n > 0:
            self._buffers[name][i:i + n] = block[:n]
            self._idx[name] = i + n

    def tick(self) -> None:  # kept for API symmetry; add() self-advances
        pass

    def data(self) -> Dict[str, np.ndarray]:
        return {k: v[: self._idx[k]] for k, v in self._buffers.items()}

    def flush(self) -> str:
        data = self.data()
        np.savez(self.path + ".npz", **data)
        try:
            import scipy.io
            scipy.io.savemat(self.path + ".mat",
                             {k.replace("/", "_"): v for k, v in data.items()})
        except Exception:  # scipy optional at runtime
            pass
        return self.path + ".npz"


def scan_with_stream(body, carry, length: int, trace: TraceBuffer,
                     chunk: int = 64, ordered: bool = True):
    """Device-resident loop with telemetry STREAMING to the host — the
    MatLogger-inside-the-RT-loop analog (the reference logs inside its
    1 kHz Xenomai loop, /root/reference/src/QPPVMPlugin.cpp:322-325; the
    deployable device-resident shape keeps the loop in one ``lax.scan``
    where a plain host-dispatch logger cannot reach).

    ``body(carry, None) -> (carry, channels)`` is a ``lax.scan`` body whose
    per-tick output is a dict of named channel arrays. The loop runs as
    ``length // chunk`` outer iterations of a ``chunk``-tick inner scan;
    each outer iteration ships the stacked (chunk, ...) channel block to
    ``trace`` with ONE ``io_callback`` — chunking amortizes the host
    round-trip to 1/chunk per tick while the loop itself never leaves the
    device. With ``ordered=True`` blocks arrive in sequence and
    ``TraceBuffer.add_block`` appends them directly.

    ``length`` must be a multiple of ``chunk``. Returns the final carry.
    """
    if length % chunk != 0:
        raise ValueError(f"length {length} not a multiple of chunk {chunk}")
    import jax
    from jax.experimental import io_callback

    def _emit(blocks):
        for name, block in blocks.items():
            trace.add_block(name, block)

    def outer(c, _):
        c, ys = jax.lax.scan(body, c, None, length=chunk)
        io_callback(_emit, None, ys, ordered=ordered)
        return c, None

    carry, _ = jax.lax.scan(outer, carry, None, length=length // chunk)
    return carry


_LOGGERS: Dict[str, "ConsoleLogger"] = {}


class Severity(enum.IntEnum):
    DEBUG = 10
    LOW = 15
    MID = 20
    HIGH = 30
    FATAL = 50


class ConsoleLogger:
    """Severity-leveled console logger (XBot::Logger analog)."""

    def __init__(self, name: str = "qppvm"):
        self._log = logging.getLogger(name)
        if not self._log.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "[%(asctime)s %(levelname)s %(name)s] %(message)s"))
            self._log.addHandler(h)
            self._log.setLevel(logging.INFO)

    def info(self, msg, *args, severity: Severity = Severity.MID):
        self._log.log(int(severity), msg, *args)

    def error(self, msg, *args):
        self._log.error(msg, *args)

    def warning(self, msg, *args):
        self._log.warning(msg, *args)

    def debug(self, msg, *args):
        self._log.debug(msg, *args)


def get_logger(name: str = "qppvm") -> ConsoleLogger:
    if name not in _LOGGERS:
        _LOGGERS[name] = ConsoleLogger(name)
    return _LOGGERS[name]
