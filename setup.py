"""Package setup for kungfu_tpu (reference analogue: setup.py building the
Go/C++ runtime + python wheel; here the runtime is jax/XLA + the optional
native control-plane extension under kungfu_tpu/native)."""
from setuptools import find_packages, setup

setup(
    name="kungfu-tpu",
    version="0.1.0",
    description="TPU-native adaptive distributed ML framework "
                "(KungFu capabilities, jax/XLA architecture)",
    packages=find_packages(include=["kungfu_tpu", "kungfu_tpu.*",
                                    "kungfu_tpu_torch", "kungfu_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these at first use
    package_data={"kungfu_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={
        "checkpoint": ["orbax-checkpoint"],
        "torch": ["torch"],
    },
    entry_points={
        # the reference ships four binaries (kungfu-run, -config-server,
        # -distribute, -rrun); same surface here
        "console_scripts": [
            "kft-run = kungfu_tpu.launcher.cli:main",
            "kft-config-server = kungfu_tpu.elastic.config_server:main",
            "kft-distribute = kungfu_tpu.launcher.distribute:main",
            "kft-rrun = kungfu_tpu.launcher.rrun:main",
            # beyond the reference: the serving binary
            "kft-serve = kungfu_tpu.serving.__main__:main",
            # the PyTorch/CUDA port's serving binary
            "kft-serve-torch = kungfu_tpu_torch.serving.__main__:main",
        ],
    },
)
