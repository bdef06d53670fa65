"""Environment variables read by the PyTorch/CUDA port.

| Variable | Meaning |
|---|---|
| ``DGT_NVCC``      | path of the CUDA compiler (default ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``) |
| ``DGT_BUILD_DIR`` | where the kernels' shared libraries are built (default ``deepgemm_tpu_torch/_build``) |
| ``DGT_SPARSE_GATHER`` | the decode's token gather: only ``flat`` (the default) is ported; any other value raises (``pallas`` is the next slice) |

All are read lazily, at each use, never at import.
"""

import os
from typing import Optional


def nvcc() -> Optional[str]:
    return os.environ.get('DGT_NVCC')


def build_dir() -> Optional[str]:
    return os.environ.get('DGT_BUILD_DIR')

