"""Moving tensors between the card and pinned host memory.

Copies run on PyTorch's current stream and are synchronised before the
function returns, so the caller may drop the source tensors at once
(their device memory is then free for the next phase). The pinned
buffers are made on the first offload and reused by every later one.
"""

from typing import List, Optional

import torch


def to_pinned_host(tensors: List[torch.Tensor],
                   buffers: Optional[List[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """Copy CUDA ``tensors`` into pinned host ``buffers`` (made here when
    None) and return the buffers."""
    if buffers is None:
        buffers = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   for t in tensors]
    for b, t in zip(buffers, tensors):
        b.copy_(t, non_blocking=True)
    _synchronize({t.device for t in tensors})
    return buffers


def to_device(buffers: List[torch.Tensor], device) -> List[torch.Tensor]:
    """New tensors on ``device`` holding the host ``buffers``' values."""
    return to_devices(buffers, [device] * len(buffers))


def to_devices(buffers: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """New tensors, buffer i's values on ``devices[i]`` (the members of
    a layout may sit on several cards)."""
    out = [b.to(d, non_blocking=True) for b, d in zip(buffers, devices)]
    _synchronize({torch.device(d) for d in devices})
    return out


def _synchronize(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()
