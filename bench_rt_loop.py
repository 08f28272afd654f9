"""Device-resident closed-loop RT benchmark: the deployable <=1 ms path.

One jitted ``lax.scan`` runs T ticks of (full WBC step -> contact physics),
with the STATE feeding back through the loop. Unlike a warm-only chain
(state/refs as scan constants let XLA hoist model update + stack assembly
out of the loop), nothing state-dependent can be hoisted here — the
measured per-tick time is an honest bound on the device compute of a full
control tick (model update + stack assembly + 2-level hierarchy solve +
torque reconstruction) plus the contact sim. A sim-only scan is timed too,
so the control-tick cost can be separated from the physics cost.

Health-gated: the scan's own telemetry must show zero solver failures and a
standing robot at the end, or no number is printed.

Usage: python bench_rt_loop.py [--ticks 500] [--robot humanoid] [--stream]
"""
import argparse
import json
import os
import tempfile
import time

import jax

from qppvm_tpu.device import enable_compile_cache, require_gpu

BUDGET_MS = 1.0

# The RT solver profile shared by bench.py, this loop and chip_smoke.py: the
# projected ADMM matrix (opt/qp.py n_eq_*) is ~5-conditioned, so 12 ADMM
# iterations + a 4-iteration warm NS re-converge the KKT inverse every
# tick; the guard-rejected / first-tick cold NS gets its own budget of 10
# (a 4-iteration cold start leaves ~3% inverse error). Closed-loop validated
# by tools/validate_rt_profile.py --profile eq_w4 --iters 12.
RT_SOLVER_OPTS = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
                      scale_iters=2, pinv_ns_iters=5)


def rt_plugin(model, contacts):
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin
    return ForceAccPlugin(model, contact_links=contacts, waist_link="pelvis",
                          iters=12, solver_opts=RT_SOLVER_OPTS)


def robot_contacts(robot):
    """(contact links, sole patch offsets or None) of a zoo robot."""
    if robot in ("humanoid", "biped"):
        contacts = ("l_sole", "r_sole")
        patch = [[0.10, 0.05, 0.0], [0.10, -0.05, 0.0],
                 [-0.06, 0.05, 0.0], [-0.06, -0.05, 0.0]]
        return contacts, {c: patch for c in contacts}
    return ("foot_fl", "foot_fr", "foot_hr", "foot_hl"), None


def measure(ticks=500, robot="humanoid", substeps=2, stream=False,
            stream_chunk=100, reps=3):
    """Time the device-resident loop; returns the result dict, or raises
    RuntimeError when a health gate fails (solver failures, fallen robot)."""
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    from qppvm_tpu.model import zoo
    from qppvm_tpu.runtime import robot_interface as ri

    model = zoo.by_name(robot)
    contacts, offsets = robot_contacts(robot)
    plugin = rt_plugin(model, contacts)
    st0 = ri.standing_state(model, contacts)
    sim_robot = ri.SimRobot(model, state=st0, dt=1e-3, substeps=substeps,
                            contact_links=contacts, ground_z=0.0,
                            contact_offsets=offsets)
    refs, warm, _ = plugin.on_start(sim_robot.state)

    h = 1e-3 / substeps
    sim = partial(ri._sim_step, model, h, sim_robot._contact_idx,
                  sim_robot._contact_offsets, 0.0, sim_robot.contact_kp,
                  sim_robot.contact_kd, sim_robot.mu, sim_robot.contact_kt)
    zero_kd = jnp.zeros(model.nj, jnp.float32)

    def tick(carry, _):
        st, anchors, w = carry
        tau, w, aux = plugin._step_impl(st, refs, w)
        for _ in range(substeps):
            st, anchors = sim(st, anchors, tau, st.q, zero_kd, zero_kd)
        return (st, anchors, w), (aux.solver_failed, aux.prim_res)

    def sim_only(carry, _):
        st, anchors = carry
        tau0 = jnp.zeros(model.nj, jnp.float32)
        for _ in range(substeps):
            st, anchors = sim(st, anchors, tau0, st.q, zero_kd, zero_kd)
        return (st, anchors), None

    @jax.jit
    def run(st, anchors, w):
        (st, anchors, w), (fails, prims) = jax.lax.scan(
            tick, (st, anchors, w), None, length=ticks)
        return st, anchors, w, jnp.sum(fails), jnp.max(prims)

    @jax.jit
    def run_sim(st, anchors):
        (st, anchors), _ = jax.lax.scan(sim_only, (st, anchors), None,
                                        length=ticks)
        return st, anchors

    def per_tick_ms(fn, *args, length=ticks):
        jax.block_until_ready(fn(*args))          # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / (reps * length) * 1e3

    st, anchors = sim_robot.state, sim_robot._anchors
    out, tick_ms = per_tick_ms(run, st, anchors, warm)
    _, sim_ms = per_tick_ms(run_sim, st, anchors)

    # optional: telemetry-streaming loop (MatLogger-in-the-RT-loop analog,
    # /root/reference/src/QPPVMPlugin.cpp:322-325): same closed loop, with
    # named channels shipped to a host TraceBuffer in chunked io_callbacks
    # from INSIDE the scan
    extra = {}
    if stream:
        from qppvm_tpu.runtime.logger import TraceBuffer, scan_with_stream

        def tick_ch(carry, _):
            st_c, anchors_c, w_c = carry
            tau, w_c, aux = plugin._step_impl(st_c, refs, w_c)
            for _ in range(substeps):
                st_c, anchors_c = sim(st_c, anchors_c, tau, st_c.q,
                                      zero_kd, zero_kd)
            return (st_c, anchors_c, w_c), {
                "tau_qp": tau, "prim_res": aux.prim_res,
                "fz": aux.wrenches[:, 2]}

        Ts = (ticks // stream_chunk) * stream_chunk
        trace = TraceBuffer(os.path.join(tempfile.gettempdir(),
                                         "qppvm_rt_stream"),
                            capacity=Ts * (reps + 1))
        run_stream = jax.jit(lambda s, a, w_: scan_with_stream(
            tick_ch, (s, a, w_), Ts, trace, chunk=stream_chunk))
        _, stream_ms = per_tick_ms(run_stream, st, anchors, warm, length=Ts)
        extra = {"stream_tick_ms": stream_ms,
                 "stream_overhead_ms": stream_ms - tick_ms,
                 "stream_chunk": stream_chunk}

    # ---- health gate ----------------------------------------------------
    st_f, _, _, n_fail, prim_max = out
    n_fail = int(n_fail)
    z0 = float(st0.base_pos[2])
    z1 = float(st_f.base_pos[2])
    if n_fail > 0:
        raise RuntimeError(f"{n_fail} solver failures in the loop — "
                           "refusing to report latency of a failing stack")
    if not np.isfinite(z1) or abs(z1 - z0) > 0.08:
        raise RuntimeError(f"robot did not hold its stand (z {z0:.3f} -> "
                           f"{z1:.3f}) — refusing to report")
    return {
        "metric": "rt_loop_tick_ms",
        "value": tick_ms,
        "unit": "ms/tick",
        "control_tick_ms": tick_ms - sim_ms,
        "sim_tick_ms": sim_ms,
        "ticks": ticks,
        "robot": robot,
        "dof": model.nv,
        "solver_failures": n_fail,
        "prim_res_max": float(prim_max),
        "base_drift_m": z1 - z0,
        "within_budget": bool(tick_ms <= BUDGET_MS),
        **extra,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--robot", default="humanoid")
    ap.add_argument("--substeps", type=int, default=2)
    ap.add_argument("--stream", action="store_true",
                    help="also measure the telemetry-streaming loop "
                         "(scan_with_stream chunked io_callbacks) and "
                         "report its per-tick overhead")
    ap.add_argument("--stream-chunk", type=int, default=100)
    args = ap.parse_args()
    devices = require_gpu()
    enable_compile_cache()
    res = measure(args.ticks, args.robot, args.substeps, args.stream,
                  args.stream_chunk)
    res["device"] = devices[0].device_kind
    print(json.dumps(res))


if __name__ == "__main__":
    main()
