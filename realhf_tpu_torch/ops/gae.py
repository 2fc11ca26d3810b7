"""Generalized Advantage Estimation over packed sequences, on the host.

Misaligned packing:

- ``rewards`` is 1D packed with per-sequence lengths ``l_i``;
- ``values`` is 1D packed with lengths ``l_i + 1`` (a bootstrap value
  appended per sequence);
- ``bootstrap[i]`` keeps the bootstrap value of a truncated sequence
  (1) or zeroes it for one that ended in EOS (0).

GAE is O(tokens): a reverse loop over time, vectorised over sequences in
a padded ``[n_seqs, L]`` view, in float32 numpy.
"""

from typing import Tuple

import numpy as np


def gae_padded(rewards: np.ndarray, values: np.ndarray, lengths: np.ndarray,
               bootstrap: np.ndarray, gamma: float, lam: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Padded layout: ``rewards`` [B, L] (entries past ``lengths[i]`` are
    ignored), ``values`` [B, L + 1] (``values[i, l_i]`` is the
    bootstrap). Returns (advantages, returns) [B, L] fp32, 0 past each
    sequence."""
    rewards = np.asarray(rewards, np.float32)
    values = np.asarray(values, np.float32)
    lengths = np.asarray(lengths)
    b, l = rewards.shape
    # the products of python floats are taken in double, then rounded
    decay, gamma = np.float32(gamma * lam), np.float32(gamma)
    t_idx = np.arange(l)[None, :]
    valid = t_idx < lengths[:, None]
    # factor on V(t + 1): 1 inside the sequence, ``bootstrap`` at its
    # last step, 0 beyond
    nv_factor = np.where(t_idx == lengths[:, None] - 1,
                         np.asarray(bootstrap, np.float32)[:, None],
                         valid.astype(np.float32))
    delta = rewards + gamma * values[:, 1:] * nv_factor - values[:, :-1]
    delta = np.where(valid, delta, np.float32(0.0))
    adv = np.zeros((b, l), np.float32)
    gae = np.zeros((b,), np.float32)
    for t in range(l - 1, -1, -1):
        gae = delta[:, t] + decay * valid[:, t] * gae
        adv[:, t] = gae
    adv = np.where(valid, adv, np.float32(0.0))
    returns = adv + np.where(valid, values[:, :-1], np.float32(0.0))
    return adv, returns


def gae_packed_numpy(rewards: np.ndarray, values: np.ndarray,
                     cu_seqlens: np.ndarray, bootstrap: np.ndarray,
                     gamma: float, lam: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """1D-packed misaligned GAE: ``cu_seqlens`` [B + 1] bounds the
    sequences of ``rewards``. Pads, runs ``gae_padded``, re-packs."""
    lens = np.diff(cu_seqlens).astype(np.int64)
    b, lmax = len(lens), int(lens.max())
    r_pad = np.zeros((b, lmax), np.float32)
    v_pad = np.zeros((b, lmax + 1), np.float32)
    v_off = 0
    for i, ln in enumerate(lens):
        r_pad[i, :ln] = rewards[cu_seqlens[i]:cu_seqlens[i + 1]]
        v_pad[i, :ln + 1] = values[v_off:v_off + ln + 1]
        v_off += ln + 1
    adv_p, ret_p = gae_padded(r_pad, v_pad, lens, bootstrap, gamma, lam)
    adv = np.concatenate([adv_p[i, :ln] for i, ln in enumerate(lens)])
    ret = np.concatenate([ret_p[i, :ln] for i, ln in enumerate(lens)])
    return adv, ret
