from setuptools import find_packages, setup

setup(
    name="after_tpu",
    version="0.1.0",
    description=("TPU-native timbre-transfer framework: latent rectified-flow"
                 " diffusion over a streamable neural audio codec"),
    packages=find_packages(include=["after_tpu", "after_tpu.*",
                                    "after_tpu_torch", "after_tpu_torch.*"]),
    package_data={"after_tpu.dataset": ["*.proto"],
                  "after_tpu_torch": ["csrc/*.cu"],
                  "after_tpu_torch.frontend": ["index.html"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy",
        "protobuf",
    ],
    entry_points={
        "console_scripts": [
            # mirrors the reference's `after` console script (setup.py:32-34)
            "after-tpu = after_tpu.cli.main:main",
            # the PyTorch / H100 port's commands
            "after-tpu-torch = after_tpu_torch.cli.main:main",
        ]
    },
)
