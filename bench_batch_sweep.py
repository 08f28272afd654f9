"""Throughput vs batch size for the batched WBC step (tuning aid for
bench.py): the bench.py profile at each batch size, health-gated.

Prints one JSON line per batch size. Needs a GPU.
Usage: python bench_batch_sweep.py [--batches 256,512,1024]
"""
import argparse
import json

from qppvm_tpu.device import enable_compile_cache, require_gpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="256,512,1024,2048,4096")
    args = ap.parse_args()
    devices = require_gpu()
    enable_compile_cache()

    import bench

    for batch in [int(b) for b in args.batches.split(",")]:
        _, step, bargs, _ = bench.batched_setup(batch)
        tau, _, aux = step(*bargs)
        bench.gate_batched(tau, aux, f"batch {batch}")
        dt = bench.time_step(step, bargs, reps=50)
        print(json.dumps({"batch": batch, "solves_per_s": batch / dt,
                          "ms_per_batch": dt * 1e3,
                          "solver_fail_frac": 0.0,
                          "device": devices[0].device_kind}), flush=True)


if __name__ == "__main__":
    main()
