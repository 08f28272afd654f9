"""Native C++ RT runtime tests (executor pacing + SPSC trace ring)."""
import numpy as np
import pytest

from qppvm_tpu.runtime import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def test_executor_paces_and_counts():
    ex = native.NativeExecutor(period_s=1e-3)
    ticks = []

    def cb(tick, t_s):
        ticks.append((tick, t_s))
        return True

    n = ex.run(cb, 50)
    assert n == 50
    assert len(ticks) == 50
    stats = ex.stats()
    assert stats["p99_s"] < 1e-3  # trivial callback fits the budget
    # pacing: total elapsed ~ 50 ms -> timestamps spread out
    assert ticks[-1][1] >= 0.04


def test_executor_early_stop():
    ex = native.NativeExecutor(period_s=1e-4)
    n = ex.run(lambda tick, t: tick < 10, 1000)
    assert n == 11


def test_ring_roundtrip():
    ring = native.NativeTraceRing(1 << 16)
    for i in range(10):
        assert ring.push(7, np.full(4, float(i)))
    out = []
    while True:
        rec = ring.pop()
        if rec is None:
            break
        out.append(rec)
    assert len(out) == 10
    ch, data = out[3]
    assert ch == 7
    np.testing.assert_allclose(data, 3.0)
    assert ring.dropped == 0


def test_ring_overflow_drops_not_corrupts():
    ring = native.NativeTraceRing(256)
    for i in range(100):
        ring.push(1, np.full(8, float(i)))
    assert ring.dropped > 0
    seen = 0
    while (rec := ring.pop()) is not None:
        ch, data = rec
        assert ch == 1
        assert np.all(data == data[0])  # intact record
        seen += 1
    assert seen >= 1


def test_shm_channel_same_process():
    name = "/qppvm_test_shm_a"
    pub = native.NativeSharedObject(name, size=6, create=True)
    sub = native.NativeSharedObject(name)
    seq, _ = sub.read()
    assert seq == 0  # never written
    pub.write([1, 2, 3, 4, 5, 6])
    seq, v = sub.read()
    assert seq == 2  # one completed write
    np.testing.assert_allclose(v, [1, 2, 3, 4, 5, 6])
    pub.write(np.arange(6) * 0.5)
    seq2, v2 = sub.read()
    assert seq2 == 4
    np.testing.assert_allclose(v2, np.arange(6) * 0.5)
    sub.close()
    pub.close()


def test_shm_channel_cross_process():
    """True cross-process publish/subscribe — the reference's
    Gazebo->plugin shared-memory pattern (/root/reference/src/ForceAcc.cpp:52-55)."""
    import subprocess
    import sys

    name = "/qppvm_test_shm_b"
    pub = native.NativeSharedObject(name, size=3, create=True)
    pub.write([7.0, 8.0, 9.0])
    code = (
        "from qppvm_tpu.runtime.native import NativeSharedObject;"
        f"ch = NativeSharedObject({name!r});"
        "seq, v = ch.read();"
        "assert seq == 2, seq;"
        "assert list(v) == [7.0, 8.0, 9.0], v;"
        "ch.write([1.0, 2.0, 3.0]);"
        "ch.close();"
        "print('child-ok')"
    )
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "child-ok" in out.stdout, (out.stdout, out.stderr)
    seq, v = pub.read()  # child's write visible to the parent
    assert seq == 4
    np.testing.assert_allclose(v, [1.0, 2.0, 3.0])
    pub.close()


def test_native_executor_drives_wbc_loop():
    """Close the native RT executor into a real control loop: the jitted
    ForceAcc step runs as the executor's tick callback against the contact
    sim, with the wait-free ring carrying the trace — the XCM-RT-thread
    analog e2e (/root/reference/src/QPPVMPlugin.cpp:308 + MatLogger)."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from qppvm_tpu.model import kinematics, zoo
    from qppvm_tpu.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu.runtime.native import (NativeExecutor, NativeTraceRing,
                                          available)
    from qppvm_tpu.runtime.robot_interface import SimRobot

    if not available():
        import pytest
        pytest.skip("native runtime unavailable")

    contacts = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
    model = zoo.quadruped()
    plugin = ForceAccPlugin(model, iters=40)
    st = model.home_state()
    kin = kinematics.fk(model, st)
    foot_z = min(float(kin.p[model.link_index(c)][2]) for c in contacts)
    st = dataclasses.replace(
        st, base_pos=st.base_pos - jnp.asarray([0.0, 0.0, foot_z],
                                               st.base_pos.dtype))
    robot = SimRobot(model, state=st, dt=1e-3, substeps=2,
                     contact_links=contacts)
    refs, warm_0, _ = plugin.on_start(robot.state)
    # warm the jit before pacing starts (compile would blow every deadline)
    plugin.control_loop(robot.state, refs, warm_0)

    ring = NativeTraceRing()
    state = {"warm": warm_0, "fails": 0, "ticks": 0}

    def tick(i, t_s):
        tau, w, aux = plugin.control_loop(robot.state, refs, state["warm"])
        state["warm"] = w
        state["fails"] += int(bool(aux.solver_failed))
        robot.set_reference(tau_ref=tau, q_ref=robot.state.q)
        robot.move()
        ring.push(0, np.asarray(tau))
        state["ticks"] += 1
        return True

    # CPU step is ~5-20 ms; pace at 50 ms so the budget is realistic here
    # (the 1 ms budget is a device-resident target, measured in bench.py)
    ex = NativeExecutor(period_s=0.05)
    done = ex.run(tick, n_ticks=40)
    stats = ex.stats()

    assert done == 40 and state["ticks"] == 40
    assert state["fails"] == 0
    assert stats["p50_s"] > 0.0
    assert stats["deadline_misses"] <= 5, stats
    # trace drained from the wait-free ring
    n_pop = 0
    while ring.pop() is not None:
        n_pop += 1
    assert n_pop == 40
    # robot still standing after the paced run
    assert abs(float(robot.state.base_pos[2]) - float(st.base_pos[2])) < 0.05
