"""Sweep the rollout solver's per-step FIXED costs at MPC scale (4096x8).

The round-4 stage profiler puts the 4096-batch rollout step at ~48 ms of
control tick, of which ~33.5 ms is iteration-INDEPENDENT solver setup
(Ruiz + eq-elim pinv + K build + warm NS + residuals) and only ~5 ms is
the 12 ADMM iterations; analytical MFU is 0.24% of bf16 peak — the step is
small-shape/HBM-bound, not FLOPs-bound, so the lever is FEWER passes, not
faster matmuls. Health-gated like every bench.
"""
import json
import time

import jax

from qppvm_tpu.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from qppvm_tpu.model import zoo
    from qppvm_tpu.mpc.rollout import RolloutConfig, standing_state
    from qppvm_tpu.mpc.sampling import MPPIConfig, SamplingMPC
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid()
    contacts = ("l_sole", "r_sole")
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=20)
    st = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(st)

    profiles = {
        "r3_deployed": dict(qp_iters=12, qp_warm_kinv_iters=8,
                            qp_scale_iters=2, qp_pinv_ns_iters=5),
        "trim_a": dict(qp_iters=12, qp_warm_kinv_iters=4,
                       qp_scale_iters=1, qp_pinv_ns_iters=4),
        "trim_b": dict(qp_iters=10, qp_warm_kinv_iters=4,
                       qp_scale_iters=1, qp_pinv_ns_iters=3),
        "trim_c": dict(qp_iters=8, qp_warm_kinv_iters=3,
                       qp_scale_iters=1, qp_pinv_ns_iters=3),
    }
    results = {}
    for name, prof in profiles.items():
        mppi = MPPIConfig(n_samples=args.samples, horizon=args.horizon,
                          push_std=30.0)
        rcfg = RolloutConfig(horizon=args.horizon, **prof)
        mpc = SamplingMPC(plugin, mppi, rcfg)
        U = mpc.init_plan()
        key = jax.random.PRNGKey(0)
        U2, info0 = mpc.plan(key, st, refs, warm, U)
        U2.block_until_ready()
        reps = 3
        t0 = time.perf_counter()
        for i in range(reps):
            U2, info = mpc.plan(jax.random.PRNGKey(i), st, refs, warm, U2)
        U2.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        results[name] = (dt, info)

    # readbacks AFTER all timing
    out = {}
    for name, (dt, info) in results.items():
        ff = float(info["solver_fail_frac"])
        pr = float(info["prim_res_max"])
        ok = ff == 0.0 and np.isfinite(float(info["cost_mean"]))
        out[name] = {"plan_ms": round(dt * 1e3, 1), "fail_frac": ff,
                     "prim_res_max": float(f"{pr:.3g}"), "healthy": bool(ok)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
