"""Numeric comparison helpers (counterpart of deepgemm_tpu/testing/numeric.py).
Comparisons run on the host in float64 numpy; tensors of any device and
dtype (bf16 and fp8 included) and numpy arrays are accepted."""

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """Tensor or array -> numpy. bf16 and fp8 tensors become float32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def count_bytes(*tensors) -> int:
    """Total bytes of the tensors and arrays given, nested in tuples or
    lists, ``None`` counting 0 (deepgemm_tpu/testing/numeric.py:count_bytes)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += count_bytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif t is not None:
            total += np.asarray(t).nbytes
    return total


def _raw_bytes(x) -> np.ndarray:
    """The element bytes of a tensor or array, for byte-exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.view(torch.uint8).numpy().ravel()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).ravel()


def calc_diff(x, y) -> float:
    """1 - cosine-similarity in f64."""
    x = to_numpy(x).astype(np.float64)
    y = to_numpy(y).astype(np.float64)
    denominator = (x * x + y * y).sum()
    if denominator == 0:    # all elements in x and y are 0
        return 0.0
    sim = 2 * (x * y).sum() / denominator
    return float(1 - sim)


def assert_bitwise_equal(x, y, label: str = ''):
    """Byte-exact equality with first-mismatch diagnostics. ``x`` and ``y``
    may be a tensor and a numpy array of the same element width (for
    example a torch fp8 tensor against an ml_dtypes float8 array)."""
    shape_x, shape_y = tuple(x.shape), tuple(y.shape)
    assert shape_x == shape_y, (shape_x, shape_y)
    x_bytes, y_bytes = _raw_bytes(x), _raw_bytes(y)
    assert x_bytes.size == y_bytes.size, (x_bytes.size, y_bytes.size)
    if np.array_equal(x_bytes, y_bytes):
        return
    mismatch = x_bytes != y_bytes
    mismatch_idx = int(np.flatnonzero(mismatch)[0])
    elem_size = x_bytes.size // max(1, int(np.prod(shape_x)))
    elem_idx = mismatch_idx // elem_size
    coord = tuple(int(v) for v in np.unravel_index(elem_idx, shape_x))
    raise AssertionError(
        f'bitwise mismatch{f" ({label})" if label else ""}: '
        f'num_bytes={mismatch.size}, num_mismatch={int(mismatch.sum())}, '
        f'first_byte={mismatch_idx}, elem={elem_idx}, coord={coord}, '
        f'x_byte={int(x_bytes[mismatch_idx])}, y_byte={int(y_bytes[mismatch_idx])}')
