"""Smoke run of the WBC + MPC main path on one GPU, at full width.

Phases, in order, in this one process:

1. device: require a GPU; print the card's name and power limit
   (nvidia-smi), device kind, jax/jaxlib versions, XLA_FLAGS, the compile
   cache directory and the solver matmul precision.
2. 1 kHz closed loop: the humanoid (38 generalized DoF, ForceAcc two-level
   stack, RT solver profile) for 500 device-resident ticks of WBC step +
   contact sim (bench_rt_loop.py; gates: 0 solver failures, |dz| <= 0.08 m),
   then 1000 host-dispatched ticks through runtime/plugin.py::ControlLoop
   (the path qppvm_tpu/run.py uses; same gates).
3. batched WBC step at batch 1024 (bench.py profile; gates: fail_frac 0,
   finite torques).
4. sampling MPC at config-5 scale (4096 samples x horizon 8) through
   SamplingMPC.plan (gates: fail_frac 0, finite cost).

``--four`` runs only the device phase and the 4096-sample plan on a 1-D
``rollout`` mesh over 4 GPUs against the same plan on 1 GPU.

Any failed gate raises, so the process exits non-zero. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""
import argparse
import json
import os
import subprocess
import time

import jax
import numpy as np

import bench
import bench_mpc
import bench_rt_loop
from qppvm_tpu import device

# --four: the sharded and the one-device plan differ only in reduction and
# fusion order; U is O(0.1) (noise_std 0.15), the costs O(1..10)
FOUR_TOL = {"U_new": 1e-4, "cost_mean": 1e-4}


def log(msg):
    print(msg, flush=True)


def compile_logged(jitted, args, name):
    """Compile ``jitted`` for ``args`` ahead of time; log the compile time
    and the memory analysis."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    log(f"[compile] {name}: {time.perf_counter() - t0:.1f} s, "
        f"{compiled.memory_analysis()}")
    return compiled


def phase_device():
    devices = device.require_gpu()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    import jaxlib

    from qppvm_tpu.precision import get_matmul_precision
    log(f"[device] nvidia-smi: {smi.stdout.strip()}")
    log(f"[device] {len(devices)} x {devices[0].device_kind}; jax "
        f"{jax.__version__}, jaxlib {jaxlib.__version__}; XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache "
        f"{device.enable_compile_cache()}; solver matmul precision "
        f"{get_matmul_precision()}")
    return devices


def phase_rt_loop(ticks=500, host_ticks=1000):
    rt = bench_rt_loop.measure(ticks=ticks)
    log(f"[rt-loop] {ticks} device-resident ticks: {rt['value']} ms/tick, "
        f"control tick {rt['control_tick_ms']} ms, sim {rt['sim_tick_ms']} "
        f"ms, within_budget {rt['within_budget']}, failures "
        f"{rt['solver_failures']}, base drift {rt['base_drift_m']} m")

    from qppvm_tpu.model import zoo
    from qppvm_tpu.runtime import robot_interface as ri
    from qppvm_tpu.runtime.plugin import ControlLoop

    model = zoo.humanoid()
    contacts, offsets = bench_rt_loop.robot_contacts("humanoid")
    plugin = bench_rt_loop.rt_plugin(model, contacts)

    def sim_robot():
        return ri.SimRobot(model, state=ri.standing_state(model, contacts),
                           dt=1e-3, substeps=2, contact_links=contacts,
                           ground_z=0.0, contact_offsets=offsets)

    ControlLoop(plugin, sim_robot()).run(0.005)        # compile + warm
    robot = sim_robot()
    z0 = float(robot.state.base_pos[2])
    stats = ControlLoop(plugin, robot).run(host_ticks * 1e-3)
    dz = float(robot.state.base_pos[2]) - z0
    log(f"[rt-loop] ControlLoop {host_ticks} host-dispatched ticks: p50 "
        f"{stats.p50_ms} ms, p99 {stats.p99_ms} ms, failures "
        f"{stats.solver_failures}, base drift {dz} m")
    if stats.solver_failures or not abs(dz) <= 0.08:
        raise RuntimeError("host-dispatched loop failed its gates")
    return rt, stats


def phase_batched(batch=1024, reps=10):
    _, step, bargs, _ = bench.batched_setup(batch)
    step = compile_logged(step, bargs, f"batched step B={batch}")
    tau, _, aux = step(*bargs)
    prim = bench.gate_batched(tau, aux, "batched step")
    per_s = batch / bench.time_step(step, bargs, reps)
    log(f"[batched] B={batch}: {per_s} solves/s, fail_frac 0, "
        f"prim_res_max {prim}")
    return per_s


def phase_mpc(samples=4096, horizon=8, reps=3):
    mpc, (st, refs, warm, U) = bench_mpc.make_mpc(samples, horizon)
    args = (jax.random.PRNGKey(0), st, refs, warm, U)
    plan = compile_logged(mpc._step, args, f"MPC plan {samples}x{horizon}")
    _, info = plan(*args)
    bench_mpc.gate_plan(info, "plan")
    ms = bench.time_step(plan, args, reps) * 1e3
    log(f"[mpc] {samples}x{horizon}: {ms} ms per plan step, fail_frac 0, "
        f"cost_mean {float(info['cost_mean'])}, prim_res_max "
        f"{float(info['prim_res_max'])}")
    return ms


def phase_four(samples=4096, horizon=8, n_devices=4):
    from qppvm_tpu.parallel import mesh as meshlib
    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"--four needs {n_devices} devices, found "
                           f"{len(jax.devices())}")
    out, ms = {}, {}
    for name, mesh in (("1", None),
                       (str(n_devices), meshlib.make_mesh(n_devices))):
        mpc, (st, refs, warm, U) = bench_mpc.make_mpc(samples, horizon,
                                                      mesh=mesh)
        args = (jax.random.PRNGKey(0), st, refs, warm, U)
        U2, info = mpc.plan(*args)                       # compile
        bench_mpc.gate_plan(info, f"{name} device(s)")
        ms[name] = bench.time_step(mpc.plan, args, 3) * 1e3
        out[name] = (np.asarray(U2), float(info["cost_mean"]))
    (U1, c1), (U4, c4) = out["1"], out[str(n_devices)]
    dU = float(np.max(np.abs(U4 - U1)))
    dc = abs(c4 - c1) / max(abs(c1), 1.0)
    log(f"[four] {samples}x{horizon} plan step ms: 1 device {ms['1']}, "
        f"{n_devices} devices {ms[str(n_devices)]}; max |dU_new| {dU} "
        f"(tol {FOUR_TOL['U_new']}), cost_mean {c1} vs {c4}, rel diff {dc} "
        f"(tol {FOUR_TOL['cost_mean']})")
    if not (dU <= FOUR_TOL["U_new"] and dc <= FOUR_TOL["cost_mean"]):
        raise RuntimeError("sharded plan disagrees with the one-device plan")
    return ms, dU, dc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-GPU sharded MPC plan vs 1 GPU")
    args = ap.parse_args()
    devices = phase_device()
    if args.four:
        phase_four()
        count = 4
    else:
        phase_rt_loop()
        phase_batched()
        phase_mpc()
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
