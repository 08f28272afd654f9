"""Telemetry streaming OUT of the device-resident loop.

The deployable 1 ms shape is the on-device ``lax.scan`` closed loop
(bench_rt_loop.py); the reference logs INSIDE its 1 kHz RT loop
(/root/reference/src/QPPVMPlugin.cpp:322-325). ``scan_with_stream`` feeds
TraceBuffer named channels from inside the scan via chunked io_callbacks;
this test asserts channel parity with the host-dispatch harness (the same
tick dispatched per-step with host-side ``add`` calls).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qppvm_tpu.model import zoo
from qppvm_tpu.plugins.force_acc import ForceAccPlugin
from qppvm_tpu.runtime import robot_interface as ri
from qppvm_tpu.runtime.logger import TraceBuffer, scan_with_stream

CONTACTS = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")


def test_device_stream_matches_host_dispatch(tmp_path):
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=15,
                            use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st0 = ri.standing_state(model, CONTACTS)
    robot = ri.SimRobot(model, state=st0, dt=1e-3, substeps=1,
                        contact_links=CONTACTS)
    refs, warm, _ = plugin.on_start(robot.state)
    sim = partial(ri._sim_step, model, 1e-3, robot._contact_idx,
                  robot._contact_offsets, 0.0, robot.contact_kp,
                  robot.contact_kd, robot.mu, robot.contact_kt)
    nj = model.nj
    zk = jnp.zeros(nj, jnp.float32)

    def tick(carry, _):
        st, anchors, w = carry
        tau, w, aux = plugin._step_impl(st, refs, w)
        st, anchors = sim(st, anchors, tau, st.q, zk, zk)
        channels = {"tau_qp": tau, "prim_res": aux.prim_res,
                    "fz": aux.wrenches[:, 2], "base_z": st.base_pos[2]}
        return (st, anchors, w), channels

    T, CHUNK = 64, 16
    carry0 = (robot.state, robot._anchors, warm)

    # --- device-resident path: ONE jitted program, telemetry streamed ----
    trace_dev = TraceBuffer(str(tmp_path / "dev"), capacity=T)
    run = jax.jit(lambda c: scan_with_stream(tick, c, T, trace_dev,
                                             chunk=CHUNK))
    carry_dev = run(carry0)
    jax.block_until_ready(carry_dev)

    # --- reference: the same nested-scan loop, channels as scan outputs --
    # (identical program structure minus the io_callbacks; proves the
    # STREAM delivers exactly what the loop computed, every tick, in order)
    @jax.jit
    def run_ref(c):
        def outer(cc, _):
            cc, ys = jax.lax.scan(tick, cc, None, length=CHUNK)
            return cc, ys
        c, ys = jax.lax.scan(outer, c, None, length=T // CHUNK)
        return c, jax.tree.map(
            lambda a: a.reshape((T,) + a.shape[2:]), ys)

    carry_ref, ch_ref = run_ref(carry0)

    dev = trace_dev.data()
    assert set(dev) == set(ch_ref)
    for k in dev:
        ref = np.asarray(ch_ref[k])
        assert dev[k].shape == ref.shape, k
        np.testing.assert_allclose(dev[k], ref, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # all healthy, and the stream captured every tick in order
    assert dev["prim_res"].shape[0] == T
    assert np.max(dev["prim_res"]) < plugin.RT_FAIL_TOL
    # streaming does not perturb the loop
    np.testing.assert_allclose(np.asarray(carry_dev[0].q),
                               np.asarray(carry_ref[0].q), atol=1e-7)

    # --- host-dispatch harness parity (the MatLogger workflow): separate
    # XLA programs can only agree until float noise is amplified by the
    # closed-loop contact dynamics, so compare the first chunk ------------
    trace_host = TraceBuffer(str(tmp_path / "host"), capacity=T)
    tick_j = jax.jit(tick)
    c = carry0
    for _ in range(CHUNK):
        c, ch = tick_j(c, None)
        for k, v in ch.items():
            trace_host.add(k, v)
    host = trace_host.data()
    for k in host:
        np.testing.assert_allclose(dev[k][:CHUNK], host[k], rtol=2e-3,
                                   atol=2e-4, err_msg=k)

    # flush writes the streamed channels like any MatLogger session
    out = trace_dev.flush()
    loaded = np.load(out)
    assert loaded["tau_qp"].shape == (T, nj)
