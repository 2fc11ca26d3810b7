"""Collectives over the members of one process's layout.

The port drives every member from one process, so the collectives that
GSPMD derives in the JAX package are written out here as sums and
copies of tensors moved to each member's device. They are plain PyTorch
ops: autograd differentiates them, so the backward of an all-reduce is
the all-reduce of the gradients, and of an all-gather the matching
slices. A cross-card ``.to()`` runs on the receiving card's current
stream after the sender's, which orders it against both members' work;
members that share a device share the reduced tensor and copy nothing.

Each takes the members' tensors and devices in group order and returns
one tensor per member, on its device.
"""

from typing import List, Sequence

import torch


def _shared(t: torch.Tensor, devices: Sequence[torch.device]
            ) -> List[torch.Tensor]:
    """``t`` on every device, moved once per distinct device."""
    on = {}
    for d in devices:
        if d not in on:
            on[d] = t.to(d)
    return [on[d] for d in devices]


def reduce_sum(xs: Sequence[torch.Tensor], device: torch.device
               ) -> torch.Tensor:
    """The sum of the members' tensors, on ``device``, added in member
    order."""
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


def all_reduce(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every member gets the sum of all members' tensors (reduced on the
    first member's device, then broadcast)."""
    if len(xs) == 1:
        return [xs[0]]
    return _shared(reduce_sum(xs, devices[0]), devices)


def all_reduce_max(xs: Sequence[torch.Tensor],
                   devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every member gets the elementwise max of all members' tensors."""
    out = xs[0].to(devices[0])
    for x in xs[1:]:
        out = torch.maximum(out, x.to(devices[0]))
    return _shared(out, devices)


def all_gather(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
               dim: int) -> List[torch.Tensor]:
    """Every member gets the members' tensors concatenated along
    ``dim`` in member order."""
    if len(xs) == 1:
        return [xs[0]]
    return _shared(torch.cat([x.to(devices[0]) for x in xs], dim=dim),
                   devices)


def reduce_scatter(xs: Sequence[torch.Tensor],
                   devices: Sequence[torch.device], dim: int
                   ) -> List[torch.Tensor]:
    """Member j gets the j-th of ``len(xs)`` equal chunks along ``dim``
    of the sum of all members' tensors, on its device: ``reduce_sum`` on
    the first member's device (the same order of sums as
    ``all_reduce``), then sliced. Each slice is a tensor of its own, so
    the whole sum is freed once it is sliced. The backward is the
    all-gather of the gradient slices."""
    if len(xs) == 1:
        return [xs[0]]
    total = reduce_sum(xs, devices[0])
    return [c.to(d, copy=True)
            for c, d in zip(total.chunk(len(xs), dim=dim), devices)]


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``x`` on every member's device."""
    return _shared(x, devices)


def all_to_all(send: Sequence[Sequence[torch.Tensor]],
               devices: Sequence[torch.device]) -> List[List[torch.Tensor]]:
    """``send[i][j]``, sender i's chunk for receiver j, arrives as
    ``recv[j][i]`` on ``devices[j]`` (a copy only where it changes
    device). The expert-parallel dispatch sends one shard's buffer
    slices to the experts' owners, and their outputs back, this way."""
    return [[row[j].to(d) for row in send] for j, d in enumerate(devices)]
