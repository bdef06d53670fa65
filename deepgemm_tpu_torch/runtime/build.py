"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``lib<name>-<hash>.so``, in the build directory (``DGT_BUILD_DIR``, default
``deepgemm_tpu_torch/_build``, which git ignores). The hash covers the flags
and every file under ``csrc/``, so a changed source builds anew and an
unchanged one is loaded as it is. Libraries build at first use; several
build at once (one ``nvcc`` process each).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from .. import envs

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')
SOURCES = ('dense', 'dense_dequant', 'masked', 'contiguous', 'k_grouped', 'mqa_logits',
           'paged_mqa', 'sparse_attn', 'mega_local', 'hc_prenorm', 'a2a', 'mega_ep')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = [envs.nvcc()]
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if cuda_home:
        candidates.append(os.path.join(cuda_home, 'bin', 'nvcc'))
    candidates += ['/usr/local/cuda/bin/nvcc', shutil.which('nvcc')]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError('nvcc not found: set DGT_NVCC or CUDA_HOME')


def build_dir() -> Path:
    path = Path(envs.build_dir() or CSRC.parent / '_build')
    path.mkdir(parents=True, exist_ok=True)
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in ('.cu', '.cuh'):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return build_dir() / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names=SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all at
    once. Returns each compiled library's ptxas report (registers, shared
    memory, spills). Raises with the compiler's output if one fails."""
    nvcc = _nvcc()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    reports, failures = {}, []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.dgt_error_string.argtypes = [ctypes.c_int]
            lib.dgt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str):
    """Raise if a C entry returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.dgt_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')
