"""Serving tier: the paged cache and continuous batching over the indexer
decode kernels (the counterpart of deepgemm_tpu/serving)."""

from .engine import ContinuousBatcher, PageAllocator, PagedCache, SequenceState  # noqa: F401
