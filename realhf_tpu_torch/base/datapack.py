"""Sequence-packing helpers: flattening and balanced contiguous
partitioning of a batch by token count."""

import itertools
from typing import Any, List, Sequence, Tuple, Union

import numpy as np


def flat2d(arr: Sequence[Sequence[Any]]) -> List[Any]:
    """Flatten a list of lists."""
    return list(itertools.chain(*arr))


def partition_balanced(nums: np.ndarray, k: int, min_size: int = 1) -> List[int]:
    """Contiguously partition ``nums`` into ``k`` chunks minimizing the
    maximum chunk sum, each chunk holding >= min_size elements (dynamic
    programming). Returns the k+1 boundaries, 0 and len(nums) included."""
    nums = np.asarray(nums, dtype=np.int64)
    n = len(nums)
    if n < k * min_size:
        raise ValueError(f"cannot split {n} elements into {k} chunks of "
                         f">= {min_size}")
    prefix = np.concatenate([[0], np.cumsum(nums)])

    inf = np.int64(1 << 60)
    # dp[j, i]: the least max-chunk-sum of nums[:i] in j chunks
    dp = np.full((k + 1, n + 1), inf, dtype=np.int64)
    split = np.zeros((k + 1, n + 1), dtype=np.int64)
    for i in range(min_size, n + 1):
        dp[1, i] = prefix[i]
    for j in range(2, k + 1):
        lo = (j - 1) * min_size  # least split point
        for i in range(j * min_size, n + 1):
            x = np.arange(lo, i - min_size + 1)
            cost = np.maximum(dp[j - 1, lo:i - min_size + 1],
                              prefix[i] - prefix[lo:i - min_size + 1])
            b = int(np.argmin(cost))
            dp[j, i] = cost[b]
            split[j, i] = x[b]
    bounds = [n]
    idx = n
    for j in range(k, 1, -1):
        idx = int(split[j, idx])
        bounds.append(idx)
    bounds.append(0)
    return bounds[::-1]


def min_abs_diff_partition(arr: Union[np.ndarray, List[int]], k: int,
                           min_size: int = 1) -> List[Tuple[int, int]]:
    """``partition_balanced`` as (start, end) pairs, validated."""
    arr = np.asarray(arr)
    if arr.ndim != 1:
        raise ValueError(f"The array to be partitioned must be 1D, got "
                         f"shape {arr.shape}.")
    if len(arr) < k * min_size:
        raise ValueError(
            f"Array length {len(arr)} < k * min_size = {k} * {min_size}.")
    b = partition_balanced(arr, k, min_size)
    partitions = [(b[i], b[i + 1]) for i in range(k)]
    last_end = 0
    for start, end in partitions:
        if start != last_end or end <= start:
            raise ValueError(
                f"Invalid partition {partitions} of lengths {arr} into "
                f"k={k}.")
        last_end = end
    return partitions
