"""A mesh of ranks in one process, its host-level collectives and its
symmetric memory. Counterpart of deepgemm_tpu/parallel/dist.py:1-116.

JAX runs a per-device function over a ``Mesh`` with ``shard_map``; its
collectives are XLA's. Here a :class:`Mesh` holds D ranks over a list of
torch devices, which may repeat one device (D ranks on one card, as JAX's
CPU mesh repeats the host), and :meth:`Mesh.map` runs a per-rank function
in one thread per rank, each thread on its own CUDA stream (on the CPU:
plain threads). Inside it, :func:`axis_index`, :func:`axis_size`,
:func:`psum`, :func:`all_gather` and :func:`all_to_all` are the ``jax.lax``
collectives the JAX code calls. Each is device copies ordered by CUDA
events across the ranks' streams: a rank publishes its tensor with an
event recorded on its stream, every reader's stream waits on that event
before it copies, and the writer's stream waits on every reader's event
after, so no rank reuses the memory before its peers have read it.

Every wait has a timeout (the mesh's ``timeout``, 60 s by default): the host barriers
raise :class:`TimeoutError`, and the kernels' spins trap with a diagnostic
word (``csrc/comm.cuh``). A rank that raises breaks the barrier for all
ranks, so a fault raises in every thread and in the caller instead of
hanging.

:func:`symmetric` gives each rank a buffer and a signal pad that every peer
can store into: on one card the peers' addresses are local, on several
cards of one host they are NVLink addresses (peer access is enabled when
the mesh is made). The kernels of ``csrc/comm.cuh`` take only the table of
the D ranks' addresses, the rank and D.

Out of scope: ``init_dist`` over ``torch.distributed`` (several processes
or hosts; ROADMAP.md).
"""

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..runtime.config import resolve_device

# Signal pad: PAD_KINDS kinds of PAD_RANKS u64 counters (csrc/comm.cuh).
PAD_KINDS, PAD_RANKS = 3, 64
MAX_RANKS = PAD_RANKS
# Seconds any wait of a mesh may take: its host barriers, and the spins of
# its communicating kernels (the reference's 60 s watchdog).
COMM_TIMEOUT_S = 60.0

_ctx = threading.local()


class PeerFailed(RuntimeError):
    """Raised in a rank whose barrier another rank broke by failing."""


class _Group:
    """The host side of one :meth:`Mesh.map` call: a barrier with a timeout
    and one slot per rank."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.timeout = timeout
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: List[Any] = [None] * size
        self.failed_at: Optional[float] = None

    def abort(self):
        if self.failed_at is None:
            self.failed_at = time.monotonic()
        self.barrier.abort()

    def wait(self, rank: int, what: str):
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            if self.failed_at is not None:
                raise PeerFailed(f'rank {rank}: another rank failed during {what}') from None
            self.failed_at = time.monotonic()
            raise TimeoutError(f'rank {rank}: waited more than {self.timeout} s for the other '
                               f'ranks in {what}') from None

    def exchange(self, rank: int, value: Any, what: str) -> List[Any]:
        """Every rank's ``value``, in rank order."""
        self.slots[rank] = value
        self.wait(rank, what)
        values = list(self.slots)
        self.wait(rank, what)
        return values


@dataclasses.dataclass
class SymmetricBuffer:
    """One rank's view of a symmetric allocation: its own ``data`` and
    ``pad`` (u64 signal counters, never reset), and ``table`` on its device,
    int64 [2, D]: every rank's data address, then every rank's pad address.
    ``calls`` counts the kernel calls made on it; each call's signals carry
    the next count (an epoch that only grows)."""
    rank: int
    size: int
    data: torch.Tensor
    pad: torch.Tensor
    table: torch.Tensor
    calls: int = 0

    def next_epoch(self) -> int:
        self.calls += 1
        return self.calls


class Mesh:
    """D = prod(sizes) ranks named by ``axes`` over ``devices`` (one per
    rank, repeats allowed). See the module docstring."""

    def __init__(self, axes: Sequence[Tuple[str, int]], devices: Sequence[torch.device],
                 timeout: Optional[float] = None):
        self.axis_names = tuple(name for name, _ in axes)
        self.shape = tuple(int(n) for _, n in axes)
        self.size = math.prod(self.shape)
        if self.size > MAX_RANKS:
            raise ValueError(f'{self.size} ranks: at most {MAX_RANKS}')
        self.devices = [torch.device(d) for d in devices[:self.size]]
        if len(self.devices) != self.size:
            raise ValueError(f'mesh {self.shape} needs {self.size} devices, got {len(devices)}')
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or kinds.pop() not in ('cpu', 'cuda'):
            raise ValueError(f'a mesh is all CPU or all CUDA devices: {self.devices}')
        self.is_cuda = self.devices[0].type == 'cuda'
        self.timeout = COMM_TIMEOUT_S if timeout is None else float(timeout)
        self._symm: Dict[str, List[Optional[SymmetricBuffer]]] = {}
        self.streams: List[Optional[torch.cuda.Stream]] = [None] * self.size
        # the kernels' diagnostic words (parallel/collectives.py), made at
        # first use
        self.diag = None
        if self.is_cuda:
            self.devices = [resolve_device(d if d.index is not None else 'cuda:0')
                            for d in self.devices]
            cards = sorted({d.index for d in self.devices})
            for a in cards:
                for b in cards:
                    if a != b and not torch.cuda.can_device_access_peer(a, b):
                        raise RuntimeError(f'cuda:{a} cannot access cuda:{b} as a peer: the '
                                           'mesh needs peer access between its cards')
            if len(cards) > 1:
                from . import collectives
                for a in cards:
                    for b in cards:
                        if a != b:
                            collectives.enable_peer_access(a, b)
            self.streams = [torch.cuda.Stream(device=d) for d in self.devices]

    def __repr__(self):
        return f'Mesh({dict(zip(self.axis_names, self.shape))}, {[str(d) for d in self.devices]})'

    def coords(self, rank: int) -> Dict[str, int]:
        out, rest = {}, rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = rest % n
            rest //= n
        return out

    def axis_ranks(self, rank: int, axis_name: str) -> List[int]:
        """The ranks of ``rank``'s group along ``axis_name``, in axis order."""
        if axis_name not in self.axis_names:
            raise ValueError(f'no axis {axis_name!r} in {self.axis_names}')
        mine = self.coords(rank)
        return [r for r in range(self.size)
                if all(v == mine[k] for k, v in self.coords(r).items() if k != axis_name)]

    def ranks_on_device(self, rank: int) -> int:
        return sum(d == self.devices[rank] for d in self.devices)

    def comm_blocks(self) -> int:
        """Blocks of each rank's persistent communicating kernel: the card's
        SMs shared out between the ranks on it, the fewest over the mesh, so
        that every rank's grid is the same and all of them fit side by side
        at one block an SM."""
        return min(torch.cuda.get_device_properties(d).multi_processor_count
                   // self.ranks_on_device(r) for r, d in enumerate(self.devices))

    def map(self, fn: Callable, *per_rank_args: Sequence[Any]) -> List[Any]:
        """``[fn(*(a[r] for a in per_rank_args)) for r in ranks]``, each rank
        in its own thread (on its own CUDA stream, which starts after the
        caller's current stream and which the caller's stream waits for).
        The first rank that raises makes every rank raise; its exception is
        re-raised here."""
        n = self.size
        for a in per_rank_args:
            if len(a) != n:
                raise ValueError(f'per-rank arguments: {len(a)} values for {n} ranks')
        group = _Group(n, self.timeout)
        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n
        start = {}
        if self.is_cuda:
            for d in set(self.devices):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                start[d] = ev
        done: List[Optional[torch.cuda.Event]] = [None] * n

        def run(rank: int):
            _ctx.mesh, _ctx.rank, _ctx.group = self, rank, group
            try:
                args = [a[rank] for a in per_rank_args]
                if self.is_cuda:
                    dev, stream = self.devices[rank], self.streams[rank]
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        stream.wait_event(start[dev])
                        results[rank] = fn(*args)
                        done[rank] = torch.cuda.Event()
                        done[rank].record(stream)
                else:
                    results[rank] = fn(*args)
            except BaseException as exc:      # every fault reaches the caller
                errors[rank] = exc
                group.abort()
            finally:
                _ctx.mesh = _ctx.rank = _ctx.group = None

        threads = [threading.Thread(target=run, args=(r,), daemon=True, name=f'mesh-rank-{r}')
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive():
                t.join(0.05)
                if group.failed_at is not None and \
                        time.monotonic() - group.failed_at > self.timeout:
                    break
        first = next((e for e in errors if e is not None and not isinstance(e, PeerFailed)),
                     None) or next((e for e in errors if e is not None), None)
        if first is not None:
            rank = errors.index(first)
            first.add_note(f'(raised in rank {rank} of {self!r})')
            raise first
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f'{self!r}: a rank did not finish within {self.timeout} s of '
                               'another rank failing')
        if self.is_cuda:
            for r in range(n):
                caller = torch.cuda.current_stream(self.devices[r])
                caller.wait_event(done[r])
                _record_stream(results[r], caller)
        return results


def _record_stream(value: Any, stream) -> None:
    """Tell the caching allocator that ``stream`` uses every tensor in
    ``value`` (tensors made on a rank's stream and handed to the caller)."""
    for t in _tensors(value):
        if t.is_cuda and t.device == stream.device:
            t.record_stream(stream)


def make_mesh(axes: Sequence[Tuple[str, int]], devices: Optional[Sequence] = None,
              timeout: Optional[float] = None) -> Mesh:
    """A named mesh, e.g. ``make_mesh([('dp', 1), ('ep', 8)], ['cuda:0'] * 8)``.
    ``devices`` defaults to every CUDA card (raising without one, as every
    entry point does); pass CPU devices to run the plain versions."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    return Mesh(axes, list(devices), timeout=timeout)


# ---- inside Mesh.map ------------------------------------------------------

def current() -> Tuple[Mesh, int]:
    """(mesh, rank) of the calling thread; raises outside :meth:`Mesh.map`."""
    mesh = getattr(_ctx, 'mesh', None)
    if mesh is None:
        raise RuntimeError('a collective outside Mesh.map')
    return mesh, _ctx.rank


def in_mesh() -> bool:
    return getattr(_ctx, 'mesh', None) is not None


def barrier(what: str) -> None:
    """Every rank reaches this point before any goes on (host threads only;
    no stream waits): the meetings of collectives.launch_spinning."""
    mesh, rank = current()
    _ctx.group.wait(rank, what)


def axis_index(axis_name: str) -> int:
    mesh, rank = current()
    return mesh.coords(rank)[axis_name]


def axis_size(axis_name: str) -> int:
    mesh, _ = current()
    return mesh.shape[mesh.axis_names.index(axis_name)]


def _gather_tensors(x: torch.Tensor, axis_name: str, what: str) -> List[torch.Tensor]:
    """The group's tensors along ``axis_name``, in axis order, each usable
    on the caller's stream; ``_release`` must follow once they are read."""
    mesh, rank = current()
    group = _ctx.group
    ev = None
    if mesh.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream())
    values = group.exchange(rank, (x, ev), what)
    members = mesh.axis_ranks(rank, axis_name)
    if mesh.is_cuda:
        stream = torch.cuda.current_stream()
        for r in members:
            if r != rank:
                stream.wait_event(values[r][1])
    return [values[r][0] for r in members]


def _release(what: str) -> None:
    """Second half of a collective: every rank's stream waits until every
    peer's stream has finished reading what it published."""
    mesh, rank = current()
    ev = None
    if mesh.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream())
    values = _ctx.group.exchange(rank, ev, what)
    if mesh.is_cuda:
        stream = torch.cuda.current_stream()
        for r, e in enumerate(values):
            if r != rank:
                stream.wait_event(e)


def psum(x, axis_name: str):
    """Sum over the group, in axis order (the same bits on every rank). A
    Python number is summed on the host: ``psum(1, axis)`` is the size."""
    if not isinstance(x, torch.Tensor):
        mesh, rank = current()
        values = _ctx.group.exchange(rank, x, 'psum')
        return sum(values[r] for r in mesh.axis_ranks(rank, axis_name))
    parts = _gather_tensors(x, axis_name, 'psum')
    out = parts[0].to(x.device, copy=True)
    for p in parts[1:]:
        out += p.to(x.device)
    _release('psum')
    return out


def all_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` in axis order."""
    parts = _gather_tensors(x, axis_name, 'all_gather')
    out = torch.empty((len(parts), *x.shape), dtype=x.dtype, device=x.device)
    for i, p in enumerate(parts):
        out[i].copy_(p)
    _release('all_gather')
    return out


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis_name, 0, 0, tiled=False)``: x [n, ...];
    slot s of the result is rank s's chunk for this rank."""
    mesh, rank = current()
    n = len(mesh.axis_ranks(rank, axis_name))
    if x.shape[0] != n:
        raise ValueError(f'all_to_all: leading dim {x.shape[0]}, axis size {n}')
    me = axis_index(axis_name)
    parts = _gather_tensors(x, axis_name, 'all_to_all')
    out = torch.empty_like(x)
    for s, p in enumerate(parts):
        out[s].copy_(p[me])
    _release('all_to_all')
    return out


def uneven_all_gather(x: torch.Tensor, axis_name: str, sizes: Sequence[int]) -> torch.Tensor:
    """Pad-gather-trim all-gather of unevenly sized shards."""
    pad = max(sizes) - x.shape[0]
    xp = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x
    gathered = all_gather(xp, axis_name)
    return torch.cat([gathered[i, :sizes[i]] for i in range(len(sizes))])


def symmetric(name: str, nbytes: int) -> SymmetricBuffer:
    """This rank's view of the mesh's symmetric buffer ``name`` of at least
    ``nbytes``, made (or grown) by a rendezvous of every rank: each
    allocates its data on its device, its signal pad once (zeroed, and the
    zeros on the device before any peer can learn its address), and the
    ranks exchange their addresses. Every rank must call it alike."""
    mesh, rank = current()
    if not mesh.is_cuda:
        raise RuntimeError('symmetric buffers live on CUDA devices')
    per = mesh._symm.setdefault(name, [None] * mesh.size)
    cur = per[rank]
    if cur is not None and cur.size >= nbytes:
        return cur
    size = max(16, -(-int(nbytes) // 16) * 16)
    dev = mesh.devices[rank]
    data = torch.empty(size, dtype=torch.uint8, device=dev)
    pad = cur.pad if cur is not None else torch.zeros(PAD_KINDS * PAD_RANKS, dtype=torch.int64,
                                                      device=dev)
    torch.cuda.current_stream().synchronize()
    values = _ctx.group.exchange(rank, (data.data_ptr(), pad.data_ptr()), f'symmetric {name!r}')
    table = torch.tensor([[d for d, _ in values], [p for _, p in values]], dtype=torch.int64)
    per[rank] = SymmetricBuffer(rank=rank, size=size, data=data, pad=pad,
                                table=table.to(data.device),
                                calls=cur.calls if cur is not None else 0)
    return per[rank]


def dist_print(*args, rank: Optional[int] = None, **kwargs):
    """Print stamped with the calling rank (0 outside a mesh); with ``rank``
    only on that rank."""
    me = _ctx.rank if in_mesh() else 0
    if rank is None or me == rank:
        print(f'[rank {me}]', *args, **kwargs)


class CollectiveWatchdog:
    """Failure detection around a host-side sync point, as the JAX
    package's: on expiry it prints a rank-stamped diagnostic (and calls
    ``on_timeout``) without killing the process; ``fatal=True`` raises
    ``TimeoutError`` on exit instead. The kernels' own spins are bounded on
    the card (``csrc/comm.cuh``)."""

    def __init__(self, timeout_s: float = 60.0, label: str = '', on_timeout=None,
                 fatal: bool = False):
        self.timeout_s = timeout_s
        self.label = label
        self.on_timeout = on_timeout
        self.fatal = fatal
        self.fired = False
        self._timer = None

    def _fire(self):
        self.fired = True
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        dist_print(f'WATCHDOG: collective section {self.label!r} exceeded '
                   f'{self.timeout_s:.0f}s: a peer may have failed (devices: {count})')
        if self.on_timeout is not None:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._timer.cancel()
        if self.fired and self.fatal and exc_type is None:
            raise TimeoutError(f'collective section {self.label!r} exceeded '
                               f'{self.timeout_s:.0f}s')
        return False


def blocking_collective(out, timeout_s: float = 60.0, label: str = '',
                        fatal: bool = False) -> bool:
    """Wait for the device work behind ``out`` under a
    :class:`CollectiveWatchdog`; returns whether it fired."""
    with CollectiveWatchdog(timeout_s, label=label, fatal=fatal) as wd:
        devices = {t.device for t in _tensors(out) if t.is_cuda}
        for d in devices:
            torch.cuda.synchronize(d)
    return wd.fired


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
