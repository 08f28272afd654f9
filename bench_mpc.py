"""Sampling-MPC benchmark (BASELINE config 5): domain-randomized WBC-in-the-
loop rollouts batched per planning step, sharded over the device mesh.

Prints ONE JSON line: QP-solves/s sustained inside the MPC rollout fan-out
(each rollout step runs a full WBC QP), plus planning-step wall time.

Health-gated: every rollout in the measured batch must pass its per-step QP
health check (solver_fail_frac == 0, the batch analog of
/root/reference/src/ForceAcc.cpp:189-193) or the bench refuses to print — a
throughput of failed solves is not a throughput.

Needs a GPU. Usage: python bench_mpc.py [--samples 512] [--horizon 8]
"""
import argparse
import json
import time

import jax

from qppvm_tpu.device import enable_compile_cache, require_gpu


def make_mpc(samples, horizon, mesh=None, robot="humanoid", qp_iters=12,
             warm_kinv_iters=8):
    """The config-5 planner: ForceAcc plugin (20 ADMM iterations on the RT
    tick), rollouts with the trimmed horizon-chain QP profile, 30 N base
    pushes. Returns (mpc, (state, refs, warm, U0))."""
    from qppvm_tpu.model import zoo
    from qppvm_tpu.mpc.rollout import RolloutConfig, standing_state
    from qppvm_tpu.mpc.sampling import MPPIConfig, SamplingMPC
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin

    model = zoo.by_name(robot)
    contacts = (("l_sole", "r_sole") if robot in ("humanoid", "biped")
                else ("foot_fl", "foot_fr", "foot_hr", "foot_hl"))
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=20)
    st = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(st)
    rcfg = RolloutConfig(horizon=horizon, qp_iters=qp_iters,
                         qp_warm_kinv_iters=warm_kinv_iters)
    mpc = SamplingMPC(plugin, MPPIConfig(n_samples=samples, horizon=horizon,
                                         push_std=30.0), rcfg, mesh=mesh)
    return mpc, (st, refs, warm, mpc.init_plan())


def gate_plan(info, what):
    """Health gate of one plan step; raises on failure."""
    import numpy as np
    fail_frac = float(info["solver_fail_frac"])
    if not np.isfinite(float(info["cost_mean"])):
        raise RuntimeError(f"MPC rollout cost non-finite ({what}) — "
                           "rollouts diverged; numbers would be bogus")
    if fail_frac > 0.0:
        raise RuntimeError(
            f"solver_fail_frac={fail_frac:.4f} (prim_res_max="
            f"{float(info['prim_res_max']):.4g}) in {what} batch — rollout "
            "QPs unhealthy; refusing to report failed-solve throughput")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--robot", default="humanoid")
    ap.add_argument("--qp-iters", type=int, default=12)
    ap.add_argument("--warm-kinv-iters", type=int, default=8)
    # Bridge declared scale and cadence: measure the largest healthy sample
    # count whose plan step fits a 1/hz budget on this device, sweeping
    # batch sizes downward from --samples. Emits samples_at_{hz}hz in the
    # JSON line. 0 disables the sweep.
    ap.add_argument("--sweep-hz", type=float, default=0.0)
    args = ap.parse_args()
    devices = require_gpu()
    enable_compile_cache()

    from qppvm_tpu import bench_util
    from qppvm_tpu.parallel import mesh as meshlib

    mesh = meshlib.make_mesh() if len(devices) > 1 else None
    kw = dict(robot=args.robot, qp_iters=args.qp_iters,
              warm_kinv_iters=args.warm_kinv_iters)
    mpc, (st, refs, warm, U) = make_mpc(args.samples, args.horizon,
                                        mesh=mesh, **kw)
    key = jax.random.PRNGKey(0)
    U2, info = mpc.plan(key, st, refs, warm, U)
    gate_plan(info, "warmup")
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        U2, info = mpc.plan(jax.random.PRNGKey(i), st, refs, warm, U2)
    U2.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    gate_plan(info, "timed")

    # ---- cadence sweep: largest sample count that fits 1/hz ------------
    sweep_fields = {}
    if args.sweep_hz > 0:
        budget_s = 1.0 / args.sweep_hz
        n = args.samples
        found = None
        while n >= 64:
            mpc_n, _ = make_mpc(n, args.horizon, mesh=mesh, **kw)
            Un, info_n = mpc_n.plan(jax.random.PRNGKey(7), st, refs, warm,
                                    mpc_n.init_plan())
            Un.block_until_ready()  # compile
            t0 = time.perf_counter()
            for i in range(3):
                Un, info_n = mpc_n.plan(jax.random.PRNGKey(10 + i), st,
                                        refs, warm, Un)
            Un.block_until_ready()
            dt_n = (time.perf_counter() - t0) / 3
            gate_plan(info_n, f"sweep{n}")
            if dt_n <= budget_s:
                found = (n, dt_n)
                break
            n //= 2
        tag = f"{args.sweep_hz:g}hz"
        sweep_fields = {f"samples_at_{tag}": found[0] if found else 0,
                        f"plan_ms_at_{tag}": found[1] * 1e3 if found
                        else None}

    # FLOP utilization of the whole planning step (analytical jaxpr matmul
    # FLOPs / measured wall / device peak). FLOPs are linear in the sample
    # count, so trace an 8-sample probe and scale.
    PROBE = 8
    mpc_p, (_, _, _, U_p) = make_mpc(PROBE, args.horizon, **kw)
    flops = bench_util.jaxpr_matmul_flops(
        mpc_p._step_impl, key, st, refs, warm, U_p) * (args.samples / PROBE)
    n_dev = mesh.devices.size if mesh is not None else 1
    util = bench_util.mfu(flops, dt, devices[0].device_kind,
                          n_devices=n_dev)

    qp_solves = args.samples * args.horizon
    print(json.dumps({
        "metric": "mpc_qp_solves_per_s",
        "value": qp_solves / dt,
        "unit": "solves/s",
        "vs_baseline": (qp_solves / dt) / 10000.0,
        "plan_step_ms": dt * 1e3,
        "samples": args.samples,
        "horizon": args.horizon,
        "qp_iters": args.qp_iters,
        "solver_fail_frac": float(info["solver_fail_frac"]),
        "prim_res_max": float(info["prim_res_max"]),
        "cost_mean": float(info["cost_mean"]),
        "ess": float(info["ess"]),
        "f32_flop_utilization": util,
        "program_flops_per_plan": flops,
        **sweep_fields,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": n_dev},
    }))


if __name__ == "__main__":
    main()
