"""Packaging for deepgemm_tpu — parity with the reference's setup.py
(/root/reference/setup.py:102-214), re-targeted at the TPU build:

  * there is no AOT-compiled extension (the reference ships ``deep_gemm._C``);
    the native host runtime (csrc/dgt_runtime.cpp) ships as SOURCE inside the
    wheel and is compiled on first use by runtime/native.py — the same
    "compile at use time, cache by content hash" model the reference uses for
    its device kernels (csrc/jit/compiler.hpp:100-149);
  * install-time env defaults can be baked into deepgemm_tpu/envs.py
    (reference: setup.py:140-147).
"""

import os
import shutil

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNativeSource(build_py):
    """Copy csrc/ into the package so the on-demand native build works from
    an installed wheel (analog of shipping the include/ tree,
    /root/reference/setup.py:201-207)."""

    def run(self):
        super().run()
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
        dst = os.path.join(self.build_lib, 'deepgemm_tpu', '_csrc')
        if os.path.isdir(src):
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(src, dst)


setup(
    name='deepgemm_tpu',
    version='0.1.0',
    description='TPU-native block-scaled GEMM engine (DeepGEMM capabilities '
                'on JAX/Pallas)',
    packages=find_packages(include=['deepgemm_tpu', 'deepgemm_tpu.*',
                                    'deepgemm_tpu_torch', 'deepgemm_tpu_torch.*']),
    package_data={'deepgemm_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=['jax', 'numpy'],
    cmdclass={'build_py': BuildWithNativeSource},
)
