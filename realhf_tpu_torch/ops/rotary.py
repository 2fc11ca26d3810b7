"""Rotary position embeddings, in fp32, from explicit position ids, so
packed prefill and KV-cache decode share one code path. Includes the
linear and dynamic-NTK scalings."""

from typing import Optional, Tuple

import torch


def rotary_freqs(positions: torch.Tensor, head_dim: int, base: float,
                 scaling: Optional[float] = None,
                 scaling_type: Optional[str] = None,
                 max_positions: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` of any shape ``S``;
    returns two fp32 tensors of shape ``S + (head_dim // 2,)``."""
    if scaling_type is not None and scaling is None:
        raise ValueError("rotary scaling_type set but scaling factor is None")
    pos = positions.to(torch.float32)
    base_t = torch.tensor(base, dtype=torch.float32,
                          device=positions.device)
    if scaling_type == "linear":
        pos = pos / scaling
    elif scaling_type == "dynamic":
        if max_positions is None:
            raise ValueError("dynamic NTK rotary scaling requires max_positions")
        # Dynamic NTK: enlarge the base when sequences exceed the
        # trained context.
        seq_len = positions.max().to(torch.float32) + 1
        ratio = torch.clamp(seq_len / max_positions, min=1.0)
        base_t = base_t * (scaling * ratio - (scaling - 1)) ** (
            head_dim / (head_dim - 2))
    elif scaling_type is not None:
        raise NotImplementedError(f"rotary scaling type {scaling_type}")
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    inv_freq = 1.0 / (base_t ** exponents)
    angles = pos[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 interleaved: bool = False) -> torch.Tensor:
    """Rotate q or k. x: [..., n_heads, head_dim]; cos/sin broadcast
    over the head axis: [..., head_dim // 2]. Computed in fp32, returned
    in x's dtype."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    xf = x.to(torch.float32)
    if interleaved:
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x1 = xf[..., :half]
        x2 = xf[..., half:]
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        out = torch.cat([o1, o2], dim=-1)
    return out.to(x.dtype)
