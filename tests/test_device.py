"""Device helpers and benchmark accounting: the compile-cache location,
the GPU requirement of measurement paths, published peaks and the FLOP
count."""
import pathlib

import jax
import jax.numpy as jnp
import pytest

from qppvm_tpu import bench_util, device

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      before[1])


def test_compile_cache_honours_env_var(monkeypatch, tmp_path,
                                       restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert device.enable_compile_cache() == path      # stable across calls
    assert jax.config.jax_compilation_cache_dir == path


def test_require_gpu_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_peak_flops_unknown_device_raises(kind):
    with pytest.raises(KeyError):
        bench_util.peak_flops(kind)
    with pytest.raises(KeyError):
        bench_util.mfu(1e12, 1.0, kind)


def test_h100_peaks_and_utilization():
    kind = "NVIDIA H100 80GB HBM3"
    assert bench_util.peak_flops(kind) == 67e12
    assert bench_util.peak_flops(kind, "tf32") == 495e12
    assert bench_util.PEAKS[kind]["hbm_bytes"] == 3.35e12
    # 6.7 TFLOP in 1 s on 2 devices = 5% of the float32 peak
    assert bench_util.mfu(6.7e12, 1.0, kind, n_devices=2) == \
        pytest.approx(0.05)


def test_flop_count_walks_nested_jaxprs():
    def f(x):
        def body(c, _):
            return jax.lax.cond(c[0, 0] > 0, lambda: c @ c, lambda: c), None
        y, _ = jax.lax.scan(body, x, None, length=3)
        return jax.jit(lambda a: a @ a)(y) @ y

    # the scan body counts times its trip count, the cond at its max branch,
    # the inner jit once: 3 + 1 + 1 products of 2 * 4^3 FLOPs
    assert bench_util.jaxpr_matmul_flops(f, jnp.ones((4, 4))) == \
        5 * 2 * 4 ** 3
