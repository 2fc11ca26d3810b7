"""Sequence-packing helpers."""

import itertools
from typing import Any, List, Sequence


def flat2d(arr: Sequence[Sequence[Any]]) -> List[Any]:
    """Flatten a list of lists."""
    return list(itertools.chain(*arr))
