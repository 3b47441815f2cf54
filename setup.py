"""Package setup (ref: the reference ships a setup.py at the repo root)."""
from setuptools import find_packages, setup

setup(
    name="waveformml_tpu",
    version="0.1.0",
    description=("TPU-native JAX/XLA/Pallas framework for scintillation-"
                 "detector waveform analysis (PROSPECT), with the "
                 "capabilities of WaveformML"),
    packages=find_packages(include=["waveformml_tpu", "waveformml_tpu.*",
                                    "waveformml_tpu_torch*"]),
    package_data={"waveformml_tpu": ["config_requirements.json"],
                  "waveformml_tpu_torch": ["config_requirements.json"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "h5py", "scipy",
        "matplotlib", "tensorboardX",
    ],
)
