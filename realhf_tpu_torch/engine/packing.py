"""Packing variable-length sequences into the model's ``[B, L]``
stream layout, with L rounded up to a bucket multiple so shapes stay
few."""

from typing import List, Tuple

import numpy as np

DEFAULT_BUCKET = 128


def left_padded_prompts(prompts: List[np.ndarray], pad_id: int,
                        bucket: int = DEFAULT_BUCKET
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the generation prefill batch: [B, Lp] left-padded token
    matrix + segment ids (1 over content) + positions. Left padding
    keeps every stream's last prompt token at column Lp-1 so decode
    appends uniformly (reference pads KV likewise,
    real_llm_generate.py:179)."""
    b = len(prompts)
    lp = max(len(p) for p in prompts)
    lp = ((lp + bucket - 1) // bucket) * bucket
    ids = np.full((b, lp), pad_id, np.int32)
    seg = np.zeros((b, lp), np.int32)
    pos = np.zeros((b, lp), np.int32)
    for i, p in enumerate(prompts):
        ids[i, lp - len(p):] = p
        seg[i, lp - len(p):] = 1
        pos[i, lp - len(p):] = np.arange(len(p))
    return ids, seg, pos
