"""Benchmark: batched whole-body QP solves/s on one GPU, single-step
dispatch latency, and the device-resident 1 ms closed-loop verdict
(bench_rt_loop.py, run in this process).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Health-gated: refuses to print a number unless every solve in the measured
batch passed its QP health check (solver_fail_frac == 0) — the batch analog
of the reference's per-tick solve-failure signal
(/root/reference/src/QPPVMPlugin.cpp:246-249).

p99 is a real percentile over >=1000 individually timed single-step
dispatches (warm-start state carried across calls like the 1 kHz loop
would); dispatch overhead is included.

Needs a GPU: exits non-zero without one.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench_rt_loop
from qppvm_tpu.device import enable_compile_cache, require_gpu

TARGET_SOLVES_PER_S = 10_000.0  # BASELINE.json north-star target
BUDGET_MS = 1.0


def batched_setup(batch, seed=0):
    """The batched WBC step of the humanoid (38 generalized DoF, ForceAcc
    two-level stack, RT solver profile): returns (plugin, jitted vmapped
    step, (states, refs, warm) batch, per-item (state, refs, warm))."""
    from qppvm_tpu.model import zoo
    from qppvm_tpu.mpc.rollout import standing_state

    model = zoo.humanoid()
    contacts, _ = bench_rt_loop.robot_contacts("humanoid")
    plugin = bench_rt_loop.rt_plugin(model, contacts)
    state = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(state)
    bcast = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), t)
    states = bcast(state)
    # vary states slightly so nothing is constant-folded
    dq = 0.01 * jax.random.normal(jax.random.PRNGKey(seed),
                                  (batch, model.nj), jnp.float32)
    states = dataclasses.replace(states, q=states.q + dq)
    step = jax.jit(jax.vmap(plugin._step_impl))
    return plugin, step, (states, bcast(refs), bcast(warm)), \
        (state, refs, warm)


def gate_batched(tau, aux, what):
    """Health gate of one batched step; raises on failure, else returns
    the worst relative primal residual."""
    fail_frac = float(jnp.mean(aux.solver_failed.astype(jnp.float32)))
    if not bool(jnp.all(jnp.isfinite(tau))):
        raise RuntimeError(f"{what}: torque is non-finite; refusing")
    if fail_frac > 0.0:
        raise RuntimeError(
            f"{what}: solver_fail_frac={fail_frac:.4f} (prim_res_max="
            f"{float(jnp.max(aux.prim_res)):.4g}) — unhealthy solves")
    return float(jnp.max(aux.prim_res))


def time_step(step, args, reps=10):
    """Seconds per call of an already-compiled step."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    import argparse

    from qppvm_tpu import bench_util

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args()
    devices = require_gpu()
    enable_compile_cache()

    # ---- throughput: batched full WBC steps (one QP cascade per item) ----
    BATCH = args.batch
    plugin, step, bargs, (state, refs, warm) = batched_setup(BATCH)
    tau, _, aux = step(*bargs)
    prim_res_max = gate_batched(tau, aux, "batched step")
    dt_total = time_step(step, bargs)
    solves_per_s = BATCH / dt_total

    # ---- matmul FLOPs of the batched program / wall time / peak ----------
    # Analytical jaxpr count (XLA's cost_analysis omits scan trip counts).
    # FLOPs are linear in batch, so trace a batch-8 probe and scale.
    PROBE = 8
    flops = bench_util.jaxpr_matmul_flops(
        jax.vmap(plugin._step_impl),
        *jax.tree.map(lambda a: a[:PROBE], bargs)) * (BATCH / PROBE)
    device_kind = devices[0].device_kind
    flop_util = bench_util.mfu(flops, dt_total, device_kind)

    # ---- latency: measured per-step distribution -------------------------
    # >=1000 individually timed dispatches of the single (non-batched) WBC
    # step, chaining the warm state across calls exactly like the 1 kHz
    # control loop.
    step1 = jax.jit(plugin._step_impl)
    tau1, w, aux1 = step1(state, refs, warm)
    tau1.block_until_ready()
    N_LAT = 1000
    lat_ms = np.empty(N_LAT)
    fails = [aux1.solver_failed]
    for i in range(N_LAT):
        t0 = time.perf_counter()
        tau1, w, aux1 = step1(state, refs, w)
        tau1.block_until_ready()
        lat_ms[i] = (time.perf_counter() - t0) * 1e3
        fails.append(aux1.solver_failed)
    n_lat_fail = int(np.sum(np.asarray(jnp.stack(fails))))
    if n_lat_fail:
        raise RuntimeError(f"{n_lat_fail} latency-loop solves failed")
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))

    # ---- device-resident closed-loop budget verdict (in this process) ----
    rt = bench_rt_loop.measure(ticks=500)

    print(json.dumps({
        "metric": "wbc_qp_solves_per_s_per_chip",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / TARGET_SOLVES_PER_S,
        "batch": BATCH,
        "dof": plugin.model.nv,
        "solver_fail_frac": 0.0,
        "prim_res_max": prim_res_max,
        "p50_step_ms": p50,
        "p99_step_ms": p99,
        "latency_samples": N_LAT,
        "p99_within_budget": p99 <= BUDGET_MS,
        "f32_flop_utilization": flop_util,
        "program_flops_per_batch_step": flops,
        "rt_loop_tick_ms": rt["value"],
        "rt_control_tick_ms": rt["control_tick_ms"],
        "within_budget": rt["within_budget"],
        "device": {"platform": devices[0].platform, "kind": device_kind,
                   "count": 1},
    }))


if __name__ == "__main__":
    main()
