"""Benchmark accounting: analytical matmul FLOPs and the device peaks they
are divided by.

FLOPs come from the traced program (``jaxpr_matmul_flops``), divided by
measured wall time and the device's published peak (``PEAKS``). The solver
runs its matmuls in float32 outside the tensor cores (precision.py), so
``mfu`` divides by the float32 peak unless told otherwise.
"""
from __future__ import annotations

# Published peaks per device_kind (NVIDIA H100 SXM data sheet, dense, at the
# full 700 W power limit): FLOP/s per matmul precision and HBM bytes/s.
# A device that is not in this table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "tf32": 495e12,
                              "bf16": 989e12, "hbm_bytes": 3.35e12},
}


def peak_flops(device_kind: str, precision: str = "f32") -> float:
    """Published peak FLOP/s of ``device_kind`` at a matmul precision
    (``PEAKS``); raises KeyError for an unknown device."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add a row with its source to "
                       "bench_util.PEAKS")
    return PEAKS[device_kind][precision]


def _prod(xs) -> float:
    out = 1.0
    for x in xs:
        out *= float(x)
    return out


def _dot_general_flops(eqn) -> float:
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    a = eqn.invars[0].aval
    b = eqn.invars[1].aval
    batch = _prod(a.shape[i] for i in lb)
    K = _prod(a.shape[i] for i in lc)
    M = _prod(a.shape[i] for i in range(len(a.shape))
              if i not in tuple(lc) + tuple(lb))
    N = _prod(b.shape[i] for i in range(len(b.shape))
              if i not in tuple(rc) + tuple(rb))
    return 2.0 * batch * M * N * K


def _jaxpr_flops(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += _dot_general_flops(eqn)
        elif name == "conv_general_dilated":
            # not used in this repo's hot paths; count as 0 rather than
            # guessing — keeps the MFU a lower bound
            pass
        elif name == "scan":
            total += eqn.params["length"] * _jaxpr_flops(
                eqn.params["jaxpr"].jaxpr)
        elif name == "while":
            # trip count unknown statically: count ONE iteration (lower
            # bound; the repo's solvers are fixed-iteration scans, not
            # while loops)
            total += _jaxpr_flops(eqn.params["body_jaxpr"].jaxpr)
        elif name == "cond":
            total += max((_jaxpr_flops(br.jaxpr)
                          for br in eqn.params["branches"]), default=0.0)
        else:
            for key in ("jaxpr", "call_jaxpr"):
                sub = eqn.params.get(key) if eqn.params else None
                if sub is not None:
                    total += _jaxpr_flops(
                        sub.jaxpr if hasattr(sub, "jaxpr") else sub)
                    break
    return total


def jaxpr_matmul_flops(fn, *args, **kwargs) -> float:
    """Analytical matmul FLOPs (2*M*N*K per dot_general) of one execution
    of ``fn``, by walking its jaxpr — scan bodies multiplied by their trip
    counts (which XLA's own cost analysis omits), cond branches counted at
    their max. Elementwise work is excluded, so the resulting utilization
    is a strict lower bound on total-FLOP utilization."""
    import jax

    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    return _jaxpr_flops(closed.jaxpr)


def mfu(flops_per_exec: float, seconds_per_exec: float, device_kind: str,
        n_devices: int = 1, precision: str = "f32") -> float:
    """FLOP utilization: program FLOPs / wall time / aggregate peak.
    ``n_devices``: devices participating in the measured program (a
    sharded plan step divides its FLOPs over the mesh, so the peak is the
    mesh's). Raises KeyError for a device without published peaks."""
    return flops_per_exec / seconds_per_exec / (
        peak_flops(device_kind, precision) * max(1, n_devices))
