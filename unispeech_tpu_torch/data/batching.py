"""Token-budget batch packing and static-shape bucketing (host numpy).

Counterpart of the JAX package's ``data/batching.py``: ``batch_by_size``
runs the native packer (``native/packer.cpp``), one linear pass over
caller-ordered indices closing a batch when the token budget max_len * bsz
or the sentence cap would overflow, aligned down to a bsz multiple;
``batch_by_size_plain`` is the same scan in Python, its plain version.
Bucket lengths, the per-epoch orders and the per-data-rank batch shards
are the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _is_batch_full(num_sentences: int, num_tokens: int, max_tokens: int,
                   max_sentences: int) -> bool:
    if num_sentences == 0:
        return False
    if max_sentences > 0 and num_sentences == max_sentences:
        return True
    if max_tokens > 0 and num_tokens > max_tokens:
        return True
    return False


def batch_by_size(
    indices: np.ndarray,  # (N,) dataset indices, caller-ordered
    sizes: np.ndarray,  # (N,) num_tokens per index, aligned with `indices`
    max_tokens: int = 0,
    max_sentences: int = 0,
    bsz_mult: int = 1,
) -> List[np.ndarray]:
    """Consecutive runs of ``indices`` whose padded size stays within the
    budget; raises when one index alone exceeds ``max_tokens``."""
    from unispeech_tpu_torch.native import batch_by_size_native

    indices, sizes = _checked(indices, sizes, max_tokens)
    out, start = [], 0
    for end in batch_by_size_native(sizes, max_tokens, max_sentences, bsz_mult):
        out.append(indices[start:end])
        start = end
    return out


def _checked(indices, sizes, max_tokens):
    indices = np.asarray(indices)
    sizes = np.asarray(sizes)
    if max_tokens > 0 and len(sizes) and int(sizes.max()) > max_tokens:
        bad = indices[int(np.argmax(sizes))]
        raise AssertionError(
            f"sentence at index {bad} of size {int(sizes.max())} exceeds "
            f"max_tokens limit of {max_tokens}")
    return indices, sizes


def batch_by_size_plain(
    indices: np.ndarray,
    sizes: np.ndarray,
    max_tokens: int = 0,
    max_sentences: int = 0,
    bsz_mult: int = 1,
) -> List[np.ndarray]:
    """The Python scan of ``batch_by_size``: its plain version."""
    indices, sizes = _checked(indices, sizes, max_tokens)
    batches: List[np.ndarray] = []
    start = 0
    sample_len = 0  # max size within the current batch
    for i in range(len(indices)):
        sample_len = max(sample_len, int(sizes[i]))
        num_sentences = i - start
        num_tokens = (num_sentences + 1) * sample_len
        if _is_batch_full(num_sentences, num_tokens, max_tokens, max_sentences):
            # align the batch size down to a bsz_mult multiple
            mod = num_sentences % bsz_mult
            take = num_sentences - mod if num_sentences > bsz_mult else num_sentences
            take = max(take, 1)
            batches.append(indices[start : start + take])
            start = start + take
            sample_len = int(sizes[start : i + 1].max()) if start <= i else 0
    if start < len(indices):
        batches.append(indices[start:])
    return batches


def length_buckets(
    max_size: int,
    min_size: int = 16000,
    num_buckets: int = 10,
    multiple: int = 320,
) -> np.ndarray:
    """Geometric bucket boundaries, rounded up to a frame-hop multiple so
    frame counts are stable across bucket members."""
    edges = np.geomspace(min_size, max_size, num_buckets)
    edges = np.unique((np.ceil(edges / multiple) * multiple).astype(np.int64))
    edges[-1] = max(edges[-1], max_size)
    return edges


def bucket_for(sizes: np.ndarray, buckets: np.ndarray) -> np.ndarray:
    """Padded length for each size: the smallest bucket >= size."""
    idx = np.searchsorted(buckets, sizes, side="left")
    idx = np.minimum(idx, len(buckets) - 1)
    return buckets[idx]


def ordered_indices(
    sizes: np.ndarray,
    seed: int,
    epoch: int,
    shuffle: bool = True,
    chunk_size: Optional[int] = None,
) -> np.ndarray:
    """Length-sorted indices with a random tiebreak from (seed, epoch); with
    ``chunk_size``, runs of that many shuffled as units."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    n = len(sizes)
    if not shuffle:
        return np.argsort(sizes, kind="mergesort")
    noise = rng.permutation(n)
    order = np.lexsort((noise, sizes))
    if chunk_size:
        chunks = [order[i : i + chunk_size] for i in range(0, n, chunk_size)]
        rng.shuffle(chunks)
        order = np.concatenate(chunks)
    return order


def chunk_shuffled_indices(
    sizes: np.ndarray,
    chunk_ids: np.ndarray,  # (N,) shard index per row, -1 = unsharded
    seed: int,
    epoch: int,
    max_sample_size: int,
    group: int = 10,
) -> np.ndarray:
    """Shard-locality-preserving shuffle for zip-sharded corpora: the shard
    order permuted per epoch, then each run of ``group`` shards sorted by
    length (capped at max_sample_size), longest first, with a random
    tiebreak. Rows of one archive stay near each other, so reads stay
    sequential per shard, while batches still get near-uniform lengths."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    n_chunks = int(chunk_ids.max()) + 1
    chunk_rows = [np.flatnonzero(chunk_ids == c) for c in range(n_chunks)]
    loose = np.flatnonzero(chunk_ids < 0)
    if len(loose):
        chunk_rows.append(loose)
    order = rng.permutation(len(chunk_rows))
    out: List[np.ndarray] = []
    for g0 in range(0, len(order), group):
        rows = np.concatenate([chunk_rows[c] for c in order[g0 : g0 + group]])
        capped = np.minimum(sizes[rows], max_sample_size)
        noise = rng.permutation(len(rows))
        sort_idx = np.lexsort((noise, capped))[::-1]
        out.append(rows[sort_idx])
    return np.concatenate(out) if out else np.arange(0)


def shard_batches(
    batches: List[np.ndarray], num_shards: int, shard_id: int,
) -> List[np.ndarray]:
    """Every num_shards-th batch from shard_id, the tail remainder dropped
    so that all shards take the same number of steps."""
    usable = (len(batches) // num_shards) * num_shards
    return batches[shard_id:usable:num_shards]
