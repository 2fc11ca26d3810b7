"""Block-granular paged KV pool: the KV substrate shared by the decode
slots and the pooled radix prefix cache.

One device arena of fixed-size **blocks** (``block_len`` token rows
each), a host free list with per-block refcounts, and per-sequence
**block tables** mapping window row ``j`` of a sequence to pool row
``table[j // block_len] * block_len + j % block_len``. Sequences take
blocks as they grow and give them back at harvest, so live-KV bytes
follow the tokens actually held, not worst-case windows.

The arena is row-flat and head-major, ``[n_layers, n_kv_heads, n_rows,
head_dim]`` with ``n_rows = (n_blocks + 1) * block_len``, so a block is
a contiguous row span and gathers/scatters are plain row indexing.
**Block 0 is reserved** as a write-off scratch block: unset table
entries and masked scatter lanes all land on its rows. ``index_copy_``
with duplicate indices is nondeterministic on CUDA, and only scratch
rows ever receive duplicates, so live rows are written exactly once.

Every sequence fills its window compacted from row 0, so token
position ``p`` sits at offset ``p % block_len`` of its block in every
sequence: a shared token prefix has the same block-internal layout
everywhere, which is what lets the radix cache alias whole blocks into
a new sequence's table with no KV copy.

``dtype="int8"`` stores int8 values with an fp32 scale per (layer,
kv-head, row): per-row amax scales keep the round-trip error within
``amax / 254`` per row. Quantize-on-write and dequantize-on-read live
in ``pool_scatter`` / ``pool_gather``, so the compute never sees int8.

Over the members of a ``dNtM`` layout (``devices``, ``t``) every
member keeps an arena of every block over its own ``nkv / t`` KV heads
(where t does not divide the KV heads, every head: the "seq" route's
members each gather their slice of a window), on its device. The int8
scales are per (layer, head, row), so splitting the heads changes no
stored value. One allocator serves every data group; the generator
copies a block aliased into another group's slot into that group's
arenas (``engine/inflight_members.copy_blocks``).

The allocator (``alloc``/``free``/``incref``) is plain host Python
that runs between device calls. :meth:`KVPool.host_only` builds a pool
without device tensors, for fakes and scheduler tests.
"""

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from realhf_tpu_torch.base.device import DeviceLike, resolve_device

KV_CACHE_DTYPES = ("fp32", "bf16", "int8")

_STORE = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


class KVPoolOOM(RuntimeError):
    """An allocation the free list cannot satisfy; carries the
    shortfall so the scheduler can relieve exactly that much."""

    def __init__(self, requested: int, free: int):
        super().__init__(
            f"KV pool exhausted: requested {requested} block(s), "
            f"{free} free")
        self.requested = requested
        self.free = free

    @property
    def shortfall(self) -> int:
        return self.requested - self.free


@dataclasses.dataclass(frozen=True)
class PoolMeta:
    block_len: int
    quant: bool              # int8 storage + per-row scales


class KVPool:
    """Device block arena + host block allocator. ``device`` defaults
    to the card (``base/device.py``)."""

    def __init__(self, cfg, n_blocks: int, block_len: int,
                 dtype: str = "fp32", device: DeviceLike = None, *,
                 devices: Optional[Sequence] = None, t: int = 1):
        if dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, "
                f"got {dtype!r}")
        if n_blocks < 1 or block_len < 1:
            raise ValueError("n_blocks and block_len must be >= 1")
        self.cfg = cfg
        self.n_blocks = int(n_blocks)
        self.block_len = int(block_len)
        self.dtype = dtype
        self.meta = PoolMeta(block_len=self.block_len,
                             quant=(dtype == "int8"))
        # host allocator state: ids 1..n_blocks; 0 reserved (scratch)
        self._free: List[int] = list(range(self.n_blocks, 0, -1))
        self._ref = np.zeros(self.n_blocks + 1, np.int32)
        self._ref[0] = 1  # the scratch block is never allocatable
        self.stats_counters = dict(allocs=0, frees=0, oom=0)

        self._members: List[Dict[str, torch.Tensor]] = []
        self.device = None
        self.t = int(t)
        self.devices: List[torch.device] = []
        if cfg is not None:
            self.devices = ([torch.device(x) for x in devices]
                            if devices is not None
                            else [resolve_device(device)])
            self.device = self.devices[0]
            nl, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
            heads = nkv // self.t if nkv % self.t == 0 else nkv
            rows = (self.n_blocks + 1) * self.block_len
            sdt = _STORE[dtype]
            for dev in self.devices:
                z = dict(device=dev)
                arr = dict(
                    k=torch.zeros((nl, heads, rows, hd), dtype=sdt, **z),
                    v=torch.zeros((nl, heads, rows, hd), dtype=sdt, **z))
                if self.meta.quant:
                    arr["k_scale"] = torch.zeros(
                        (nl, heads, rows), dtype=torch.float32, **z)
                    arr["v_scale"] = torch.zeros(
                        (nl, heads, rows), dtype=torch.float32, **z)
                self._members.append(arr)
            itemsize = torch.empty((), dtype=sdt).element_size()
            self._bytes_per_row = 2 * nl * nkv * (
                hd * itemsize + (4 if self.meta.quant else 0))
        else:
            self._bytes_per_row = 0

    @classmethod
    def host_only(cls, n_blocks: int, block_len: int,
                  bytes_per_row: int = 0) -> "KVPool":
        """Allocator arithmetic without device tensors."""
        pool = cls(None, n_blocks, block_len, dtype="fp32")
        pool._bytes_per_row = int(bytes_per_row)
        return pool

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The device tensors (``pool_scatter`` writes them in place); of
        the first member over members."""
        return self.member_arrays(0)

    def member_arrays(self, i: int) -> Dict[str, torch.Tensor]:
        """Member ``i``'s arena."""
        if not self._members:
            raise RuntimeError("host_only pool has no device arrays")
        return self._members[i]

    # -- allocator ------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def block_bytes(self) -> int:
        return self._bytes_per_row * self.block_len

    @property
    def bytes_per_row(self) -> int:
        return self._bytes_per_row

    def blocks_for_rows(self, rows: int) -> int:
        return -(-max(0, int(rows)) // self.block_len)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks at refcount 1, all or nothing: raises
        :class:`KVPoolOOM` without side effects when fewer are free."""
        n = int(n)
        if n <= 0:
            return []
        if len(self._free) < n:
            self.stats_counters["oom"] += 1
            raise KVPoolOOM(n, len(self._free))
        out = [self._free.pop() for _ in range(n)]
        self._ref[out] = 1
        self.stats_counters["allocs"] += n
        return out

    def incref(self, blocks: Iterable[int]):
        for b in blocks:
            if self._ref[b] <= 0 or b == 0:
                raise ValueError(f"incref on unallocated block {b}")
            self._ref[b] += 1

    def free(self, blocks: Iterable[int]):
        """Drop one reference per listed block; blocks reaching zero
        return to the free list."""
        for b in blocks:
            if b == 0:
                continue
            if self._ref[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(int(b))
                self.stats_counters["frees"] += 1

    def ref(self, block: int) -> int:
        return int(self._ref[block])

    def stats(self) -> Dict:
        in_use = self.n_in_use
        return dict(
            blocks_total=self.n_blocks, blocks_free=self.n_free,
            blocks_in_use=in_use, block_len=self.block_len,
            block_bytes=self.block_bytes,
            bytes_per_row=self._bytes_per_row,
            bytes_in_use=in_use * self.block_bytes,
            bytes_total=self.n_blocks * self.block_bytes,
            dtype=self.dtype, **self.stats_counters)


# ----------------------------------------------------------------------
# gather / scatter over the arrays dict
# ----------------------------------------------------------------------
def window_rows(bt: torch.Tensor, warange: torch.Tensor,
                block_len: int) -> torch.Tensor:
    """Flat pool rows [B, S] of window positions ``warange`` [S] of
    each sequence in block table ``bt`` [B, max_blocks]. Unset entries
    (0) resolve into the scratch block, whose rows are read masked."""
    cols = (warange // block_len).long()
    return bt[:, cols].long() * block_len + (warange % block_len)[None, :]


def pool_gather(meta: PoolMeta, arrays, rows: torch.Tensor,
                compute_dtype: torch.dtype):
    """Dequantized ``(k, v)``, each a new contiguous ``[nl, B, nkv, S,
    hd]`` tensor in ``compute_dtype``, for flat pool rows ``rows``
    [B, S]. Gathered one layer at a time, so an int8 pool's fp32
    dequantization never holds more than one layer."""
    nl, nkv, _, hd = arrays["k"].shape
    b, s = rows.shape
    flat = rows.reshape(-1).long()
    outs = []
    for name in ("k", "v"):
        src = arrays[name]
        out = torch.empty((nl, b, nkv, s, hd), dtype=compute_dtype,
                          device=src.device)
        for li in range(nl):
            x = src[li].index_select(1, flat)            # [nkv, B*S, hd]
            if meta.quant:
                scale = arrays[f"{name}_scale"][li].index_select(1, flat)
                x = x.to(torch.float32) * scale[..., None]
            out[li] = x.view(nkv, b, s, hd).transpose(0, 1)
        outs.append(out)
    return outs[0], outs[1]


def _quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: ``x`` [..., hd] -> (int8 values, fp32
    scales [...]); divide, round half to even, clip, cast."""
    amax = x.abs().amax(-1)
    scale = (amax / 127.0).to(torch.float32)
    q = torch.where(scale[..., None] > 0,
                    x.to(torch.float32) / scale[..., None].clamp_min(1e-30),
                    0.0)
    q = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    return q, scale


def pool_scatter(meta: PoolMeta, arrays, rows: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 mask: torch.Tensor):
    """Write ``k_new``/``v_new`` ([nl, B, nkv, m, hd]) at flat pool rows
    ``rows`` [B, m], in place. Masked-off lanes go to row 0 of the
    scratch block, never to a live row, so duplicate indices only ever
    hit scratch. Returns the arrays dict."""
    safe = torch.where(mask, rows.long(), 0).reshape(-1)
    nl, b, nkv, m, hd = k_new.shape
    for name, new in (("k", k_new), ("v", v_new)):
        # [nl, B, nkv, m, hd] -> [nl, nkv, B*m, hd]
        vals = new.transpose(1, 2).reshape(nl, nkv, b * m, hd)
        if meta.quant:
            q, scale = _quantize_rows(vals)
            arrays[name].index_copy_(2, safe, q)
            arrays[f"{name}_scale"].index_copy_(2, safe, scale)
        else:
            arrays[name].index_copy_(2, safe,
                                     vals.to(arrays[name].dtype))
    return arrays


def int8_roundtrip_error_bound(x: np.ndarray) -> float:
    """The per-row bound the int8 path guarantees: half a quantization
    step, ``amax / 254`` per row."""
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    return float(np.max(amax) / 254.0 + 1e-12)
