"""The one-sided all-to-all between the ranks of a mesh: the wrapper of the
CUDA kernel (csrc/a2a.cu), its plain version and its launch count.
Counterpart of deepgemm_tpu/parallel/collectives.py:29-104.

``pallas_all_to_all(x, axis_name)`` is ``jax.lax.all_to_all(x, axis_name,
0, 0, tiled=False)`` inside :meth:`Mesh.map`: slot s of the result is rank
s's chunk for this rank. On CUDA tensors each rank launches the kernel: an
entry barrier, then one-sided stores of chunk d into slot [my] of rank d's
receive buffer (the mesh's symmetric buffer 'a2a'), a release signal per
rank, then the arrivals, copied out of the receive buffer. On the CPU (and
under ``plain_versions``) the plain version is the mesh's host
``all_to_all``; the bytes are the same.
"""

import ctypes
import threading
import weakref

import torch

from ..kernels.common import COUNT_LOCK, use_plain
from ..runtime import build
from . import dist

# Kernel launches since the count was last set to 0.
launches = 0
_diag_lock = threading.Lock()


def _lib():
    lib = build.load('a2a')
    if lib.dgt_a2a.argtypes is None:
        lib.dgt_a2a.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
                                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.dgt_a2a.restype = ctypes.c_int
        lib.dgt_enable_peer_access.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dgt_enable_peer_access.restype = ctypes.c_int
        lib.dgt_diag_alloc.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.POINTER(ctypes.c_void_p)]
        lib.dgt_diag_alloc.restype = ctypes.c_int
        lib.dgt_diag_free.argtypes = [ctypes.c_void_p]
        lib.dgt_diag_free.restype = ctypes.c_int
    return lib


_DIAG_WORDS = 8


def _diag(mesh: 'dist.Mesh'):
    """The mesh's diagnostic words, 8 int64 a rank in mapped pinned host
    memory: (host address, device address), made once."""
    with _diag_lock:
        if mesh.diag is None:
            lib = _lib()
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            code = lib.dgt_diag_alloc(mesh.size * _DIAG_WORDS * 8, ctypes.byref(host),
                                      ctypes.byref(dev))
            build.check(lib, code, 'diagnostic words')
            mesh.diag = (host.value, dev.value)
            weakref.finalize(mesh, lib.dgt_diag_free, host.value)
        return mesh.diag


def enable_peer_access(dev: int, peer: int) -> None:
    """Let card ``dev`` store into card ``peer``'s memory (idempotent)."""
    lib = _lib()
    build.check(lib, lib.dgt_enable_peer_access(dev, peer), f'peer access cuda:{dev} -> {peer}')


def comm_args(buf: 'dist.SymmetricBuffer'):
    """The kernels' common tail: (table, rank, D, epoch, blocks,
    timeout_ns, diag, stream) of this rank's call on ``buf``."""
    mesh, rank = dist.current()
    diag = _diag(mesh)[1] + rank * _DIAG_WORDS * 8
    return (buf.table.data_ptr(), rank, mesh.size, buf.next_epoch(), mesh.comm_blocks(),
            int(mesh.timeout * 1e9), diag, torch.cuda.current_stream().cuda_stream)


def launch_spinning(lib, what: str, buf: 'dist.SymmetricBuffer', launch) -> None:
    """Launch a persistent kernel that spins on its peers through ``buf``:
    ``launch(*comm_args(buf))`` calls the library and returns its code. The
    caller has allocated everything the call needs, its outputs included;
    every rank meets the others at a host barrier before its launch and
    again after it, so that no rank's thread is held back from its launch
    (an allocation can wait on the device) while its peers' kernels spin."""
    dist.barrier(f'{what}: allocated')
    code = launch(*comm_args(buf))
    dist.barrier(f'{what}: launched')
    build.check(lib, code, what)


def comm_diagnostic(mesh: 'dist.Mesh'):
    """The ranks whose kernel timed out waiting on a peer, from the pinned
    diagnostic words the spin writes before it traps: [(rank, kind, src,
    value seen, target, block), ...]. Readable after the trap has ended the
    context."""
    if mesh.diag is None:
        return []
    words = (ctypes.c_longlong * (mesh.size * _DIAG_WORDS)).from_address(mesh.diag[0])
    kinds = {0: 'barrier', 1: 'arrival', 2: 'combine'}
    out = []
    for r in range(mesh.size):
        flag, rank, kind, src, seen, target, block, _ = words[r * _DIAG_WORDS:(r + 1) * _DIAG_WORDS]
        if flag:
            out.append((rank, kinds.get(kind, kind), src, seen, target, block))
    return out


def pallas_all_to_all(x: torch.Tensor, axis_name: str = 'ep',
                      collective_id: int = 0) -> torch.Tensor:
    """All-to-all of ``x`` [D, ...] over ``axis_name`` (split and concat on
    axis 0) with one-sided stores; inside :meth:`Mesh.map`. The JAX
    package's ``collective_id`` names a barrier semaphore; here every call
    shares the mesh's buffer 'a2a', whose entry barrier orders the calls."""
    del collective_id
    mesh, rank = dist.current()
    d_dim = dist.axis_size(axis_name)
    if x.shape[0] != d_dim:
        raise ValueError(f'pallas_all_to_all: leading dim {x.shape[0]}, axis size {d_dim}')
    if use_plain(x):
        return dist.all_to_all(x, axis_name)       # the kernel's plain version
    if d_dim != mesh.size:
        raise NotImplementedError(f'the all-to-all kernel spans the whole mesh ({mesh.size} '
                                  f'ranks); axis {axis_name!r} has {d_dim}')
    x = x.contiguous()
    chunk = x[0].numel() * x.element_size()
    out = torch.empty_like(x)
    if chunk == 0:
        return out
    buf = dist.symmetric('a2a', d_dim * chunk)
    global launches
    lib = _lib()
    launch_spinning(lib, 'a2a', buf, lambda *comm: lib.dgt_a2a(x.data_ptr(), out.data_ptr(),
                                                              chunk, *comm))
    with COUNT_LOCK:
        launches += 1
    return out
