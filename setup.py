from setuptools import find_packages, setup

setup(
    name="qppvm_tpu",
    version="0.1.0",
    description="Whole-body control + MPC engine in JAX (XLA/Pallas, GPU)",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
)
