"""Packaging for theanet_tpu (reference setup.py equivalent; deps are the
TPU-native stack instead of numpy+Theano) and its PyTorch + CUDA port
theanet_tpu_torch, whose CUDA sources ship as package data and are built
at first use."""

from setuptools import find_packages, setup

setup(
    name="theanet_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) image-classification training framework "
        "with the capability surface of rakeshvar/theanet"
    ),
    packages=find_packages(include=["theanet_tpu", "theanet_tpu.*",
                                    "theanet_tpu_torch",
                                    "theanet_tpu_torch.*"]),
    package_data={"theanet_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "theanet-train = theanet_tpu.train:main",
        ]
    },
)
