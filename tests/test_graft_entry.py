"""Driver-contract tests: entry() compiles single-device; dryrun_multichip
executes on the virtual 8-device CPU mesh."""
import pathlib
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    tau = out[0]
    tau.block_until_ready()
    assert np.all(np.isfinite(np.asarray(tau)))
    assert tau.shape == (32,)  # humanoid actuated joints


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    assert len(jax.devices()) >= 8
    ge.dryrun_multichip(8)
