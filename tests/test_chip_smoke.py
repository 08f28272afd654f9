"""chip_smoke.py's phases at tiny sizes on the CPU: the control flow, the
gates and the comparisons the GPU run relies on (not its speed)."""
import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def test_main_refuses_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main()
    assert '"ok"' not in capsys.readouterr().out


def test_phase_rt_loop_tiny():
    rt, stats = cs.phase_rt_loop(ticks=3, host_ticks=3)
    assert rt["solver_failures"] == 0 and abs(rt["base_drift_m"]) < 0.08
    assert stats.solver_failures == 0 and len(stats.latencies_s) == 3


def test_phase_batched_tiny(capsys):
    assert cs.phase_batched(batch=2, reps=1) > 0
    out = capsys.readouterr().out
    assert "[compile] batched step B=2" in out and "fail_frac 0" in out


def test_phase_mpc_tiny():
    assert cs.phase_mpc(samples=4, horizon=2, reps=1) > 0


def test_phase_four_on_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    ms, dU, dc = cs.phase_four(samples=8, horizon=2)
    assert set(ms) == {"1", "4"}
    assert dU <= cs.FOUR_TOL["U_new"] and dc <= cs.FOUR_TOL["cost_mean"]
    assert "[four]" in capsys.readouterr().out
