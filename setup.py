"""Packaging for shadowing-tpu (Path Shadowing Monte Carlo in JAX).

Builds the optional native shard-loader extension when a C toolchain is
available; the package works without it (pure-numpy fallback).
"""
import os

from setuptools import Extension, find_packages, setup

ext_modules = []
if os.environ.get("SHADOWING_TPU_NO_NATIVE") != "1":
    ext_modules.append(
        Extension(
            "shadowing_tpu.native._npyloader",
            sources=["shadowing_tpu/native/npyloader.c"],
            extra_compile_args=["-O3", "-std=c11", "-pthread"],
            extra_link_args=["-pthread"],
            optional=True,
        )
    )

setup(
    name="shadowing-tpu",
    version="0.1.0",
    description="Path Shadowing Monte Carlo in JAX",
    packages=find_packages(include=["shadowing_tpu", "shadowing_tpu.*"]),
    package_data={"shadowing_tpu.data": ["_bundled/*.npz"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"viz": ["matplotlib"], "csv": ["pandas"],
                    "test": ["pytest", "scipy", "pandas"]},
    ext_modules=ext_modules,
)
