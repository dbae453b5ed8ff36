"""Packaging for flexflow_tpu (reference: the CMake superbuild +
setup.py pip packaging, SURVEY §2.10 — here one setup.py builds both the
Python package and the native ffcore library)."""
import pathlib
import subprocess

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py

ROOT = pathlib.Path(__file__).resolve().parent


class BuildNative(Command):
    """Build native/libffcore.so into flexflow_tpu/_native/."""

    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        subprocess.run(["make", "-C", str(ROOT / "native")], check=True)


class BuildPyWithNative(build_py):
    def run(self):
        try:
            self.run_command("build_native")
        except Exception as e:  # native is optional: pure-Python fallback
            print(f"warning: native ffcore build failed ({e}); "
                  "the pure-Python fallback will be used")
        super().run()


setup(
    name="flexflow_tpu",
    version="0.1.0",
    description="TPU-native auto-parallelizing deep learning framework "
    "(FlexFlow/Unity capabilities on JAX/XLA/Pallas)",
    packages=find_packages(
        include=["flexflow_tpu", "flexflow_tpu.*", "flexflow_tpu_torch", "flexflow_tpu_torch.*"]
    ),
    package_data={
        "flexflow_tpu._native": ["libffcore.so"],
        "flexflow_tpu.search": ["calibration_data/*.json"],
        # CUDA sources of the PyTorch port, compiled by nvcc at first use
        "flexflow_tpu_torch.ops.kernels": ["csrc/*.cu", "csrc/*.cuh"],
        # the port's tools: the canned overload storm and flexlint's baseline
        "flexflow_tpu_torch.tools": ["data/*.json", "flexlint_baseline.json"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={
        "checkpoint": ["orbax-checkpoint"],
        "frontends": ["torch"],
        "test": ["pytest"],
    },
    cmdclass={"build_native": BuildNative, "build_py": BuildPyWithNative},
)
