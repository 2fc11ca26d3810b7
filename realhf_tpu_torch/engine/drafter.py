"""Prompt-lookup (n-gram) drafting for speculative decoding.

The cheapest useful drafter (Saxena 2023 "prompt lookup decoding";
the self-speculative family of Leviathan et al. 2023): instead of a
small draft model, propose the continuation that followed the SAME
recent n-gram earlier in the request's own prompt + generated
history. On extractive/templated workloads (summarization, code
edits, RAG with quoted context) the model frequently copies spans
from its context, so this pure-host drafter reaches useful accept
rates at zero device cost. Proposals are *guesses*: the verify pass
(``engine/inflight.py`` ``_verify_chunk``) accepts exactly the tokens
greedy decoding would have produced, so a bad drafter only costs
wasted verify lanes, never correctness.
"""

from typing import Optional

import numpy as np


class NGramDrafter:
    """Propose ``k`` draft tokens by prompt lookup.

    Tries the longest suffix n-gram first (``max_ngram`` down to
    ``min_ngram``): find its most recent *earlier* occurrence in the
    history and propose the ``k`` tokens that followed it. With no
    match anywhere, falls back to repeating the last token (a decent
    guess for runs/whitespace, free to verify).
    """

    def __init__(self, k: int, max_ngram: int = 3, min_ngram: int = 1,
                 fallback_token: Optional[int] = None):
        if k <= 0:
            raise ValueError("drafter k must be positive")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.k = k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.fallback_token = fallback_token

    def propose(self, history: np.ndarray) -> np.ndarray:
        """history: [n] int token ids (prompt + generated so far).
        Returns [k] int32 draft tokens."""
        h = np.asarray(history).reshape(-1)
        n = len(h)
        out = np.empty((self.k,), np.int32)
        if n == 0:
            out[:] = 0 if self.fallback_token is None \
                else self.fallback_token
            return out
        for ng in range(min(self.max_ngram, n - 1), self.min_ngram - 1,
                        -1):
            tail = h[n - ng:]
            # most recent earlier occurrence of the suffix n-gram
            # (vectorized sliding-window compare; the final window is
            # the suffix itself, excluded)
            wins = np.lib.stride_tricks.sliding_window_view(h, ng)
            starts = np.flatnonzero((wins[:-1] == tail).all(axis=1))
            if len(starts) == 0:
                continue
            start = int(starts[-1])
            cont = h[start + ng:start + ng + self.k]
            if len(cont) == 0:
                continue  # nothing follows the match
            out[:len(cont)] = cont
            if len(cont) < self.k:
                out[len(cont):] = cont[-1]
            return out
        fb = h[-1] if self.fallback_token is None else self.fallback_token
        out[:] = fb
        return out
