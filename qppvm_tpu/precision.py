"""Matmul-precision policy.

The solver's iterative numerics need full float32 matmuls: the
Newton-Schulz inverse and the ADMM/KKT applies diverge to NaN with
bf16-input matmuls (a humanoid WBC tick returned prim_res=NaN at bf16 and
1.4e-4 with float32-pinned matmuls; the NaN then trips the zero-torque
fallback). On the GPU, float32 matmuls at default precision run as TF32 in
the tensor cores, which keeps only ~10 mantissa bits. Every public
step/solve entry point therefore pins `jax.default_matmul_precision(
"float32")` (HIGHEST: no TF32) around its trace. Whether TF32 or TF32x3
holds the health gates has not been measured. bf16 stays available
for bulk rollout physics where a caller opts in explicitly.
"""
from __future__ import annotations

import functools
import os

import jax

# "float32" (HIGHEST, default) or "bfloat16_3x" (HIGH: 3 compensated bf16
# passes, ~f32 mantissa coverage at a fraction of the cost). Plain
# "bfloat16" is known-bad here (NaNs, see module docstring). Overridable for
# measured experiments via env or set_matmul_precision(); the RT default
# stays full f32 until a sweep proves bf16_3x holds the closed-loop gates.
_PRECISION = os.environ.get("QPPVM_MATMUL_PRECISION", "float32")


def set_matmul_precision(p: str) -> None:
    """Set the solver matmul precision policy (before tracing)."""
    global _PRECISION
    _PRECISION = p


def get_matmul_precision() -> str:
    return _PRECISION


# friendly aliases -> jax DotAlgorithmPreset names
_ALIASES = {
    "float32": "float32",               # HIGHEST: full f32 accumulate
    "bfloat16_3x": "BF16_BF16_F32_X3",  # 3 compensated bf16 passes
    "bfloat16_6x": "BF16_BF16_F32_X6",
    "bfloat16": "bfloat16",             # known-bad here (NaNs)
}


def _resolve(p: str) -> str:
    return _ALIASES.get(p, p)


def f32_matmuls(fn):
    """Decorator: trace ``fn`` under the pinned matmul precision (f32 by
    default — see module docstring)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(_resolve(_PRECISION)):
            return fn(*args, **kwargs)
    return wrapped


class matmul_f32:
    """Context manager alias (``with matmul_f32():``)."""

    def __init__(self):
        self._cm = None

    def __enter__(self):
        self._cm = jax.default_matmul_precision(_resolve(_PRECISION))
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)
