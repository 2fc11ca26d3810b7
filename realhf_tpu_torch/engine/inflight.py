"""Continuous (inflight) batching for generation.

A fixed set of decode SLOTS runs a chunked decode loop; when a slot's
sequence finishes (EOS or max_new_tokens) the host harvests it and
refills the slot by prefilling the next prompt into that slot's KV rows
while the other slots keep decoding, so short sequences never wait for
the batch's longest one.

- ``decode_chunk``: up to ``chunk_size`` one-token steps for all slots
  (``transformer.decode_step`` with per-slot write indices: the decode
  kernel, K4, on the card), stopping early once no slot is live (one
  host read a step);
- ``fill_slot``: batch-1 prefill (``transformer.prefill``: the flash
  forward kernel, K1, on the card) at a bucketed, left-padded prompt
  length, written into the slot's cache rows.

The KV rows live either in a dense per-slot cache ``[n_layers, n_slots,
n_kv_heads, cache_len, head_dim]`` or in a paged block pool
(``engine/kv_pool.py``): the paged path gathers each call's window from
the pool into a new contiguous tensor, runs the same dense compute on
it, and scatters the rows it wrote back. Prompt-lookup speculative
decoding (greedy only) verifies k host-drafted tokens per slot in one
forward (``_extend_rows``, plain attention over the slot rows); radix
prefix-cache hits seed a slot's first rows from a donor and run only
the uncached suffix through that same forward.

Over the members of a ``dNtM`` layout (``params`` a
``models/sharding.MemberParams``) the slots are split over the data
groups as a batch of ``n_slots`` rows is, every decode step runs on
every member, and a fill runs on the owning group's members alone
(``engine/inflight_members.py``).

Each chunk pays one bundled device-to-host transfer (``_host_view``),
not one per slot. The PPO logits-mask replay is not supported here
(use the batch ``generate`` path).
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.base.device import DeviceLike, resolve_device
from realhf_tpu_torch.base.safetensors_io import (
    numpy_to_tensor,
    tensor_to_numpy,
)
from realhf_tpu_torch.engine import inflight_members as M
from realhf_tpu_torch.engine import kv_pool as _kvp
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.obs import tracing
from realhf_tpu_torch.ops.sampling import (
    NEG_INF,
    GenerationHyperparameters,
    categorical,
    top_k_top_p_logits,
)

logger = logging.getLogger("engine.inflight")


def _bucket(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


#: finer ladder for the partial-prefill (prefix-cache hit) path: the
#: donor window and the uncached suffix each get their own bucket, so a
#: 95%-hit request pays a small suffix bucket, not the full-prompt one
_PARTIAL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

#: per-slot state fields fetched by ``_host_view``, in bundle order
_HOST_FIELDS = ("active", "unfinished", "emitted", "hit_eos",
                "spec_proposed", "spec_accepted", "out_tokens",
                "out_logprobs")


@dataclasses.dataclass
class FinishedSequence:
    request_id: int
    tokens: np.ndarray     # [len] generated ids (incl. EOS if emitted)
    logprobs: np.ndarray   # [len]
    no_eos: bool           # never emitted EOS (hit max_new_tokens)
    #: speculative-decoding accounting of this sequence (0 without it)
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: host copies of the sequence's KV rows ([nl, nkv, len(prompt) +
    #: len(tokens), hd] each), from ``harvest(export_kv=True)``
    kv: Optional[Tuple[np.ndarray, np.ndarray]] = None
    #: paged backends (``harvest(export_blocks=True)``): the pool blocks
    #: holding the sequence's rows, each with ONE extra reference owned
    #: by the receiver, who must ``pool.free`` them; ``n_rows`` = rows
    blocks: Optional[Tuple[int, ...]] = None
    n_rows: int = 0


class InflightBatchingGenerator:
    """Slot-machine generation over a queue of prompts. ``params`` live
    on ``device`` (default the card, ``base/device.py``), or are a
    ``MemberParams`` of a dNtM layout (their members' devices; the
    per-slot bookkeeping on the first)."""

    #: the serving scheduler feature-detects the prefix-fill / KV-export
    #: extensions on this attribute
    supports_prefix_fill = True

    def __init__(self, cfg: TransformerConfig, params,
                 gconfig: GenerationHyperparameters,
                 *, n_slots: int, max_prompt_len: int,
                 eos_token_id: Optional[int], pad_token_id: int,
                 chunk_size: int = 32, spec_decode_k: int = 0,
                 drafter=None, kv_pool=None,
                 kv_cache_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        if not gconfig.force_no_logits_mask:
            raise ValueError(
                "inflight batching does not produce the PPO logits "
                "mask; set force_no_logits_mask=True or use the batch "
                "generate path.")
        T.check_supported(cfg)
        self.cfg = cfg
        self.g = gconfig
        self.n_slots = n_slots
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.chunk = chunk_size
        self.cache_len = T.round_cache_len(
            max_prompt_len + gconfig.max_new_tokens)
        #: where the slots live over a member layout (None on one device)
        self._lay: Optional[M.Layout] = None
        if isinstance(params, MemberParams):
            params = M.member_view(params)
            self._lay = M.layout_of(cfg, params, n_slots, self.cache_len)
            self.device = self._lay.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device}: the generator's "
                                 f"bookkeeping lives on its first member's "
                                 f"device, {self.device}")
        else:
            self.device = resolve_device(device)
        self.params = params
        self.kv_pool = kv_pool
        if kv_cache_dtype is not None \
                and kv_cache_dtype not in _kvp.KV_CACHE_DTYPES:
            raise ValueError(
                f"kv_cache_dtype must be one of {_kvp.KV_CACHE_DTYPES}")
        if kv_cache_dtype == "int8" and kv_pool is None:
            raise ValueError(
                "kv_cache_dtype='int8' requires a paged KV pool "
                "(dequant-on-read lives in the pool gather path); "
                "pass kv_pool=KVPool(..., dtype='int8').")
        if kv_pool is not None:
            if kv_pool.cfg is None:
                raise ValueError("paged decoding needs a device-"
                                 "backed KVPool (not host_only)")
            if self._lay is not None:
                M.check_pool(kv_pool, self._lay)
                #: per block, the data groups whose arenas hold its rows
                #: (a bit each; set when a group's slot takes the block)
                self._block_groups = np.zeros(kv_pool.n_blocks + 1,
                                              np.int64)
            elif kv_pool.t != 1 or kv_pool.device != self.device:
                raise ValueError(f"KV pool on {kv_pool.device}, "
                                 f"generator on {self.device}")
            self._blen = kv_pool.block_len
            self._max_blocks = -(-self.cache_len // self._blen)
            self._slot_blocks: List[List[int]] = [
                [] for _ in range(n_slots)]
            self._bt_host = np.zeros((n_slots, self._max_blocks),
                                     np.int32)
            self._bt_dev = None  # uploaded lazily after table changes
            #: upper bound of the window rows a slot may have written
            #: (exact at fill / spec round / harvest, + chunk per plain
            #: decode chunk): reserving capacity needs no device read
            self._slot_rows_ub = [0] * n_slots
            self._slot_prompt_n = [0] * n_slots
        self._spec_k = int(spec_decode_k or 0)
        if self._spec_k > 0 and not gconfig.greedy:
            logger.warning(
                "spec_decode_k=%d requested but gconfig.greedy is "
                "False; speculative decoding is greedy-exact only -- "
                "disabling.", self._spec_k)
            self._spec_k = 0
        self._drafter = None
        if self._spec_k > 0:
            if drafter is None:
                from realhf_tpu_torch.engine.drafter import NGramDrafter
                drafter = NGramDrafter(self._spec_k)
            self._drafter = drafter

        nm = gconfig.max_new_tokens
        dev = dict(device=self.device)
        if self.kv_pool is not None:
            # paged: the pool owns the rows; the slot keeps only its
            # write index in (compacted) window coordinates
            kv_state = dict(length=torch.zeros((n_slots,), dtype=torch.int32,
                                               **dev))
        else:
            dense_dt = {None: None, "fp32": torch.float32,
                        "bf16": torch.bfloat16}[kv_cache_dtype]
            kv_state = dict(cache=T.init_kv_cache(
                cfg, n_slots, self.cache_len, dtype=dense_dt,
                device=self.device) if self._lay is None else
                M.init_caches(cfg, self._lay, dense_dt or T.dtype_of(
                    cfg.compute_dtype)))
        i32 = dict(dtype=torch.int32, **dev)
        b = dict(dtype=torch.bool, **dev)
        cdt = T.dtype_of(cfg.compute_dtype)
        self.state = dict(
            **kv_state,
            last_hidden=torch.zeros((n_slots, cfg.hidden_dim), dtype=cdt,
                                    **dev) if self._lay is None
            else M.init_hidden(cfg, self._lay, cdt),
            prompt_len=torch.zeros((n_slots,), **i32),
            emitted=torch.zeros((n_slots,), **i32),
            active=torch.zeros((n_slots,), **b),
            unfinished=torch.zeros((n_slots,), **b),
            hit_eos=torch.zeros((n_slots,), **b),
            out_tokens=torch.full((n_slots, nm), pad_token_id, **i32),
            out_logprobs=torch.zeros((n_slots, nm), dtype=torch.float32,
                                     **dev),
            spec_proposed=torch.zeros((n_slots,), **i32),
            spec_accepted=torch.zeros((n_slots,), **i32),
        )
        self._slot_req = [-1] * n_slots  # host: request id per slot
        #: host copy of each slot's prompt (the drafter's history, and
        #: the scheduler's key for KV publication)
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * n_slots
        #: how the last fill_slot was lowered (bucket, cached_len, ...)
        self.last_fill: Dict = {}
        self.fill_stats = dict(prefill_tokens=0, prefill_tokens_saved=0)
        self.spec_stats = dict(rounds=0)
        #: device work done: one-token decode steps (each a
        #: ``decode_step`` over every slot), full prefills
        #: (``transformer.prefill``) and suffix prefills (``_extend_rows``)
        self.counts = dict(decode_steps=0, full_prefills=0,
                           suffix_prefills=0)

    # ------------------------------------------------------------------
    # Slot-level step API (``serving/scheduler.py`` drives these;
    # ``generate_all`` composes them into a run to completion).
    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r < 0]

    @property
    def n_live(self) -> int:
        """Slots bound to a request (decoding or awaiting harvest)."""
        return sum(1 for r in self._slot_req if r >= 0)

    @torch.no_grad()
    def decode_chunk(self, generator: Optional[torch.Generator] = None):
        """Advance every live slot by up to ``chunk_size`` steps.
        ``generator`` (on the generator's device) drives sampling;
        greedy decoding ignores it. With ``spec_decode_k > 0`` the chunk
        runs speculative verify rounds instead, each emitting 1..k+1
        tokens per live slot. Paged backends reserve the chunk's
        worst-case growth first and may raise
        :class:`~realhf_tpu_torch.engine.kv_pool.KVPoolOOM`."""
        if self._spec_k > 0 and self.n_live:
            self._spec_chunk()
        elif self.kv_pool is not None:
            self._paged_chunk(generator)
        else:
            self.counts["decode_steps"] += _decode_chunk(
                self.cfg, self.g, self.eos, self.pad, self.chunk,
                self.params, self.state, generator)

    # -- paged internals ------------------------------------------------
    def _win_for(self, need: int) -> int:
        """Gather-window length: the longest live row count rounded up
        to the cache-row multiple (a handful of window shapes, as the
        dense path has one per bucket)."""
        if need <= 0:
            return 0
        m = T._CACHE_LEN_MULTIPLE
        return min(self.cache_len, -(-need // m) * m)

    def _bt_device(self) -> torch.Tensor:
        if self._bt_dev is None:
            self._bt_dev = torch.from_numpy(self._bt_host).to(self.device)
        return self._bt_dev

    def _ensure_capacity(self, growth: int) -> int:
        """Reserve blocks so every live slot can append ``growth`` rows
        without a mid-chunk allocation. Raises :class:`KVPoolOOM` on
        exhaustion (earlier slots keep their new, real reservations).
        Returns the window length covering the worst case."""
        nm = self.g.max_new_tokens
        need_max = 0
        for slot in range(self.n_slots):
            if self._slot_req[slot] < 0:
                continue
            n = self._slot_prompt_n[slot]
            cap_rows = min(self._slot_rows_ub[slot] + growth,
                           n + nm, self.cache_len)
            have = len(self._slot_blocks[slot])
            need = self.kv_pool.blocks_for_rows(cap_rows) - have
            if need > 0:
                new = self.kv_pool.alloc(need)  # may raise KVPoolOOM
                self._own_blocks(slot, new)
                self._slot_blocks[slot].extend(new)
                self._bt_host[slot, have:have + len(new)] = new
                self._bt_dev = None
            self._slot_rows_ub[slot] = cap_rows
            need_max = max(need_max, cap_rows)
        return self._win_for(need_max)

    def _own_blocks(self, slot: int, blocks):
        """Fresh blocks of ``slot``: over members, held by its group's
        arenas alone."""
        if self._lay is not None and blocks:
            self._block_groups[blocks] = 1 << self._lay.group_of(slot)[0]

    def _share_blocks(self, slot: int, blocks):
        """Aliased blocks of another group's slot copied into the arenas
        of ``slot``'s group (one pool block id, one copy per group)."""
        if self._lay is None or self._lay.d == 1:
            return
        g = self._lay.group_of(slot)[0]
        by_src: Dict[int, List[int]] = {}
        for blk in blocks:
            have = int(self._block_groups[blk])
            if have >> g & 1:
                continue
            if have == 0:
                raise RuntimeError(f"pool block {blk} is held by no group")
            src = (have & -have).bit_length() - 1
            by_src.setdefault(src, []).append(blk)
            self._block_groups[blk] = have | 1 << g
        for src, blks in by_src.items():
            M.copy_blocks(self.kv_pool, self._lay, blks, src, g)

    def _warange(self, win: int) -> torch.Tensor:
        return torch.arange(win, dtype=torch.int32, device=self.device)

    def _paged_chunk(self, generator):
        win = self._ensure_capacity(self.chunk)
        if win == 0:
            return
        self.state, steps = _paged_decode_chunk(
            self.cfg, self.g, self.eos, self.pad, self.chunk,
            self.kv_pool.meta, self.params, self.kv_pool, self.state,
            self._bt_device(), self._warange(win), generator, self._lay)
        self.counts["decode_steps"] += steps

    def kv_pool_stats(self) -> Dict:
        """Pool accounting plus this generator's row usage."""
        s = self.kv_pool.stats()
        s["rows_in_use"] = sum(
            self._slot_rows_ub[i] for i in range(self.n_slots)
            if self._slot_req[i] >= 0)
        return s

    def admission_blocks_needed(self, prompt_len: int,
                                cached_len: int = 0) -> int:
        """Free-list blocks a fill of this shape takes (aliased prefix
        blocks are shared, not allocated) plus one block of headroom for
        the first decode chunk."""
        c = max(0, min(int(cached_len), int(prompt_len) - 1))
        c -= c % self._blen
        return (self.kv_pool.blocks_for_rows(prompt_len)
                - c // self._blen + 1)

    def _spec_chunk(self):
        """ceil(chunk / (k+1)) verify rounds: the plain chunk's token
        budget when every draft is accepted. Each round pays one
        bundled read (the drafter needs the history on the host) and
        one verify forward."""
        nm = self.g.max_new_tokens
        rounds = -(-self.chunk // (self._spec_k + 1))
        for _ in range(rounds):
            host = self._host_view()
            drafts = np.zeros((self.n_slots, self._spec_k), np.int32)
            n_live = 0
            for slot in range(self.n_slots):
                if (self._slot_req[slot] < 0
                        or not host["active"][slot]
                        or not host["unfinished"][slot]
                        or host["emitted"][slot] >= nm):
                    continue
                n_live += 1
                e = int(host["emitted"][slot])
                hist = np.concatenate(
                    [self._slot_prompt[slot],
                     host["out_tokens"][slot, :e].astype(np.int64)])
                drafts[slot] = self._drafter.propose(hist)
            if n_live == 0:
                break
            d = torch.from_numpy(drafts).to(self.device)
            with tracing.span("serve:spec_verify", n_live=n_live,
                              k=self._spec_k):
                if self.kv_pool is not None:
                    # the round's host view gives exact lengths: tighten
                    # the row bounds before reserving k+1 rows a slot
                    for slot in range(self.n_slots):
                        if self._slot_req[slot] >= 0:
                            self._slot_rows_ub[slot] = (
                                self._slot_prompt_n[slot]
                                + int(host["emitted"][slot]))
                    win = self._ensure_capacity(self._spec_k + 1)
                    self.state = _paged_verify(
                        self.cfg, self.g, self.eos, self._spec_k,
                        self.kv_pool.meta, self.params, self.kv_pool,
                        self.state, self._bt_device(), self._warange(win), d,
                        self._lay)
                else:
                    _verify_chunk(self.cfg, self.g, self.eos, self._spec_k,
                                  self.params, self.state, d, self._lay)
            self.spec_stats["rounds"] += 1

    def swap_params(self, params):
        """Use ``params`` from the next decode/prefill on (between
        ``decode_chunk`` calls). Over members: a ``MemberParams`` of the
        generator's layout, or a canonical tree (what a one-device
        trainer pushes), sharded onto the generator's members."""
        if self._lay is None:
            self.params = params
            return
        lay = self._lay
        if isinstance(params, MemberParams):
            params = M.member_view(params)
            if not M.fits(params, lay):
                raise ValueError(
                    f"swap_params: weights of a d{params.d}t{params.t}"
                    f"p{params.p}c{params.c} layout on "
                    f"{[str(x) for x in params.devices]} for a generator "
                    f"over d{lay.d}t{lay.t} on "
                    f"{[str(x) for x in lay.devices]}")
            self.params = params
            return
        if not isinstance(params, dict):
            raise TypeError("swap_params takes a MemberParams of the "
                            "generator's layout or a canonical param tree, "
                            f"not {type(params).__name__}")
        from realhf_tpu_torch.models.convert import params_from_numpy
        self.params = None  # the old copies go before the new ones come
        self.params = MemberParams(
            params_from_numpy(params, cfg=self.cfg, devices=lay.devices,
                              t=lay.t), list(lay.devices), lay.d, lay.t,
            ep=lay.ep)

    def release_slot(self, slot: int):
        """Abort the sequence in ``slot``: the slot is free at once and
        the partial output dropped; paged backends return its blocks
        (aliased prefix blocks drop one reference)."""
        self._slot_req[slot] = -1
        self._slot_prompt[slot] = None
        if self.kv_pool is not None and self._slot_blocks[slot]:
            self.kv_pool.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._bt_host[slot, :] = 0
            self._bt_dev = None
            self._slot_rows_ub[slot] = 0
            self._slot_prompt_n[slot] = 0
        self.state["active"][slot] = False

    def _host_view(self) -> Dict[str, np.ndarray]:
        """ONE device-to-host transfer of every per-slot output/status
        field: the fields go out as int32 columns of one tensor (fp32
        log-probs bit-cast), so harvesting or streaming N slots costs
        one synchronisation, not one per slot and field."""
        st = self.state
        cols = [st[k].to(torch.int32)[:, None] for k in _HOST_FIELDS[:6]]
        cols += [st["out_tokens"], st["out_logprobs"].view(torch.int32)]
        flat = torch.cat(cols, dim=1).cpu().numpy()
        nm = self.g.max_new_tokens
        out = {k: flat[:, i] for i, k in enumerate(_HOST_FIELDS[:6])}
        for k in ("active", "unfinished", "hit_eos"):
            out[k] = out[k].astype(bool)
        out["out_tokens"] = flat[:, 6:6 + nm]
        out["out_logprobs"] = np.ascontiguousarray(
            flat[:, 6 + nm:]).view(np.float32)
        return out

    def snapshot_slot(self, slot: int):
        """(tokens_so_far, logprobs_so_far) of the sequence in ``slot``."""
        return self.snapshot_slots([slot])[slot]

    def snapshot_slots(self, slots: List[int]) -> Dict[int, tuple]:
        """slot -> (tokens_so_far, logprobs_so_far) for every listed
        slot through one bundled read."""
        if not slots:
            return {}
        host = self._host_view()
        out: Dict[int, tuple] = {}
        for slot in slots:
            n = int(host["emitted"][slot])
            out[slot] = (host["out_tokens"][slot, :n],
                         host["out_logprobs"][slot, :n])
        return out

    def harvest(self, export_kv: bool = False,
                export_blocks: bool = False) -> List[FinishedSequence]:
        """Collect every finished sequence and free its slot (one
        bundled read). ``export_kv`` also downloads each finished slot's
        KV rows (prompt + generated, token order) in one transfer, for
        the host radix prefix cache. ``export_blocks`` (paged only)
        attaches the slot's pool blocks instead, each with one extra
        reference the caller must free: no device transfer."""
        out: List[FinishedSequence] = []
        if self.n_live == 0:
            return out
        host = self._host_view()
        slots: List[int] = []
        for slot in range(self.n_slots):
            rid = self._slot_req[slot]
            if rid < 0 or (host["active"][slot]
                           and host["unfinished"][slot]):
                continue
            n = int(host["emitted"][slot])
            out.append(FinishedSequence(
                request_id=rid,
                tokens=host["out_tokens"][slot, :n],
                logprobs=host["out_logprobs"][slot, :n],
                no_eos=not bool(host["hit_eos"][slot]),
                spec_proposed=int(host["spec_proposed"][slot]),
                spec_accepted=int(host["spec_accepted"][slot])))
            slots.append(slot)
        if export_blocks and slots:
            if self.kv_pool is None:
                raise ValueError(
                    "export_blocks requires a paged (KV-pool) backend")
            for fs, slot in zip(out, slots):
                blocks = tuple(self._slot_blocks[slot])
                self.kv_pool.incref(blocks)  # receiver-owned refs
                fs.blocks = blocks
                fs.n_rows = (self._slot_prompt_n[slot]
                             + int(host["emitted"][slot]))
        if export_kv and slots:
            if self.kv_pool is not None:
                self._export_pool_kv(out, slots, host)
            elif self._lay is not None:
                for fs, kv in zip(out, M.export_dense_kv(
                        self._lay, self.state["cache"], slots)):
                    fs.kv = kv
            else:
                self._export_dense_kv(out, slots)
        for slot in slots:
            self.release_slot(slot)
        return out

    def _export_dense_kv(self, out: List[FinishedSequence],
                         slots: List[int]):
        cache = self.state["cache"]
        idx = torch.tensor(slots, device=self.device)
        kv = tensor_to_numpy(torch.stack([cache["k"][:, idx],
                                          cache["v"][:, idx]]))
        valid = cache["valid"][idx].cpu().numpy()
        for i, fs in enumerate(out):
            # valid rows in row order ARE token order: donor prefix rows,
            # the left-padded suffix's real tail, then decode rows
            rows = np.flatnonzero(valid[i])
            fs.kv = (np.ascontiguousarray(kv[0][:, i][:, :, rows, :]),
                     np.ascontiguousarray(kv[1][:, i][:, :, rows, :]))

    def _export_pool_kv(self, out: List[FinishedSequence],
                        slots: List[int], host):
        """Paged KV export: one transfer of every finished slot's pool
        rows, dequantized on the host for int8 pools."""
        blen = self._blen
        flats, counts = [], []
        for slot in slots:
            rows = (self._slot_prompt_n[slot]
                    + int(host["emitted"][slot]))
            w = np.arange(rows)
            flats.append(self._bt_host[slot, w // blen] * blen + w % blen)
            counts.append(rows)
        if self._lay is not None:
            for fs, slot, flat in zip(out, slots, flats):
                fs.kv = M.export_pool_kv(self.kv_pool, self._lay, slot, flat)
            return
        all_rows = torch.from_numpy(np.concatenate(flats).astype(
            np.int64)).to(self.device)
        arrays = self.kv_pool.arrays()
        kv = tensor_to_numpy(torch.stack([arrays["k"][:, :, all_rows],
                                          arrays["v"][:, :, all_rows]]))
        k, v = kv[0], kv[1]
        if self.kv_pool.meta.quant:
            sc = torch.stack([arrays["k_scale"][:, :, all_rows],
                              arrays["v_scale"][:, :, all_rows]]
                             ).cpu().numpy()
            k = k.astype(np.float32) * sc[0][..., None]
            v = v.astype(np.float32) * sc[1][..., None]
        off = 0
        for fs, rows in zip(out, counts):
            fs.kv = (np.ascontiguousarray(k[:, :, off:off + rows, :]),
                     np.ascontiguousarray(v[:, :, off:off + rows, :]))
            off += rows

    @property
    def max_prompt_len(self) -> int:
        """Longest admissible prompt: the cache row minus the decode
        budget."""
        return self.cache_len - self.g.max_new_tokens

    # ------------------------------------------------------------------
    def _upload(self, *arrays: np.ndarray):
        """Same-shape int32 host arrays -> device tensors through one
        host-to-device copy."""
        dev = torch.from_numpy(np.stack(arrays)).to(self.device)
        return tuple(dev[i] for i in range(len(arrays)))

    def _prompt_window(self, prompt: np.ndarray, width: int, start: int):
        """ids/seg/pos [1, width] of ``prompt`` left-padded into a window
        of ``width``, positions counted from ``start``."""
        n = len(prompt)
        ids = np.full((1, width), self.pad, np.int32)
        seg = np.zeros((1, width), np.int32)
        pos = np.zeros((1, width), np.int32)
        ids[0, width - n:] = prompt
        seg[0, width - n:] = 1
        pos[0, width - n:] = start + np.arange(n)
        return self._upload(ids, seg, pos)

    @torch.no_grad()
    def fill_slot(self, slot: int, request_id: int,
                  prompt: np.ndarray, cached_len: int = 0,
                  prefix_kv=None, cached_blocks=None):
        """Prefill ``prompt`` into ``slot`` (a host int). With
        ``cached_len > 0`` the first ``cached_len`` positions come from
        ``prefix_kv`` (``(k, v)`` host arrays ``[nl, nkv, >=cached_len,
        hd]`` from the radix prefix cache) and only the uncached suffix
        runs the forward, bucketed by its own length. Paged backends
        take ``cached_blocks`` (pool block ids from the pooled prefix
        cache) instead: whole cached blocks are aliased into the slot's
        block table, a refcount bump with no KV copy."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = len(prompt)
        max_prompt = self.max_prompt_len
        if n > max_prompt:
            raise ValueError(
                f"prompt of {n} tokens exceeds max_prompt_len "
                f"{max_prompt}")
        if self.kv_pool is not None:
            if prefix_kv is not None:
                raise ValueError(
                    "paged backends alias pool blocks; pass "
                    "cached_blocks (not prefix_kv)")
            self._fill_slot_paged(slot, request_id, prompt,
                                  int(cached_len), cached_blocks)
            return
        if cached_blocks is not None:
            raise ValueError("cached_blocks requires a paged (KV-"
                             "pool) backend")
        c = int(cached_len)
        if c > 0 and prefix_kv is None:
            raise ValueError("cached_len > 0 requires prefix_kv")
        # the hidden state feeding the first decode step is not in the
        # KV cache: at least one real token always prefills
        c = min(c, n - 1)
        nm = self.g.max_new_tokens
        c_b = s_b = 0
        while c > 0:
            c_b = _bucket(c, _PARTIAL_BUCKETS)
            s_b = _bucket(n - c, _PARTIAL_BUCKETS)
            if c_b + s_b + nm <= self.cache_len:
                break
            # the donor's bucket overflows the cache row: trim the donor
            # to the next-lower bucket boundary (still a valid prefix)
            smaller = [b for b in _PARTIAL_BUCKETS if b < c_b]
            c = smaller[-1] if smaller else 0
        if c <= 0:
            lp = min(_bucket(n), max_prompt)
            with tracing.span("serve:prefill", slot=slot,
                              prompt_len=n, bucket=lp):
                ids, seg, pos = self._prompt_window(prompt, lp, 0)
                _prefill_into_slot(self.cfg, self.params, self.state, slot,
                                   ids, seg, pos, n, self._lay)
            self.last_fill = dict(bucket=lp, prompt_len=n,
                                  cached_len=0, prefilled=n)
            self.fill_stats["prefill_tokens"] += n
            self.counts["full_prefills"] += 1
        else:
            s = n - c
            dk, dv = (numpy_to_tensor(np.asarray(x)[:, :, :c])
                      for x in prefix_kv)
            with tracing.span("serve:prefill", slot=slot,
                              prompt_len=n, bucket=s_b, cached_len=c):
                ids, seg, pos = self._prompt_window(prompt[c:], s_b, c)
                if self._lay is None:
                    kdt = self.state["cache"]["k"].dtype
                    donor = torch.zeros((2, self.cfg.n_layers,
                                         self.cfg.n_kv_heads, c_b,
                                         self.cfg.head_dim), dtype=kdt)
                    donor[0, :, :, :c] = dk.to(kdt)
                    donor[1, :, :, :c] = dv.to(kdt)
                    donor = donor.to(self.device)
                    _prefill_suffix_into_slot(
                        self.cfg, self.params, self.state, slot, donor[0],
                        donor[1], c, ids, seg, pos, s)
                else:
                    _prefill_suffix_members(
                        self.cfg, self.params, self._lay, self.state, slot,
                        dk, dv, c, c_b, ids, seg, pos, s)
            self.last_fill = dict(bucket=s_b, prompt_len=n,
                                  cached_len=c, prefilled=s)
            self.fill_stats["prefill_tokens"] += s
            self.fill_stats["prefill_tokens_saved"] += c
            self.counts["suffix_prefills"] += 1
        self._slot_req[slot] = request_id
        self._slot_prompt[slot] = prompt

    def _fill_slot_paged(self, slot: int, request_id: int,
                         prompt: np.ndarray, cached_len: int,
                         cached_blocks):
        """Paged fill: alias whole cached blocks, allocate own blocks for
        the rest of the prompt, run the full prefill or the suffix
        forward and scatter the computed rows into the pool. May raise
        :class:`~realhf_tpu_torch.engine.kv_pool.KVPoolOOM`."""
        n = len(prompt)
        blen = self._blen
        # whole-block aliasing only: a shared partial tail block would be
        # appended into by this sequence
        c = max(0, min(int(cached_len), n - 1))
        c -= c % blen
        c_b = s_b = 0
        if c > 0 and cached_blocks is None:
            raise ValueError(
                "cached_len > 0 requires cached_blocks on a paged "
                "backend")
        if c > 0:
            c_b = _bucket(c, _PARTIAL_BUCKETS)
            s_b = _bucket(n - c, _PARTIAL_BUCKETS)
        n_alias = c // blen
        if c > 0 and len(cached_blocks) < n_alias:
            raise ValueError(
                f"cached_blocks covers {len(cached_blocks)} block(s) "
                f"but cached_len {c} spans {n_alias}")
        own = self.kv_pool.alloc(
            self.kv_pool.blocks_for_rows(n) - n_alias)
        try:
            alias = [int(b) for b in cached_blocks[:n_alias]] \
                if c > 0 else []
            if alias:
                self.kv_pool.incref(alias)
        except BaseException:
            # a bad alias chain must not leak the fresh blocks
            self.kv_pool.free(own)
            raise
        self._own_blocks(slot, own)
        self._share_blocks(slot, alias)
        blocks = alias + own
        self._slot_blocks[slot] = blocks
        self._bt_host[slot, :] = 0
        self._bt_host[slot, :len(blocks)] = blocks
        self._bt_dev = None
        self._slot_rows_ub[slot] = n
        self._slot_prompt_n[slot] = n
        # bind before the forward, so that release_slot cleans up a
        # failure below (blocks included)
        self._slot_req[slot] = request_id
        self._slot_prompt[slot] = prompt
        bt_row = self._bt_device()[slot]
        meta, arrays = self.kv_pool.meta, self.kv_pool.arrays()
        if c <= 0:
            lp = min(_bucket(n), self.max_prompt_len)
            with tracing.span("serve:prefill", slot=slot,
                              prompt_len=n, bucket=lp, paged=True):
                ids, seg, pos = self._prompt_window(prompt, lp, 0)
                if self._lay is None:
                    _paged_prefill(self.cfg, meta, self.params, arrays,
                                   self.state, slot, ids, seg, pos, bt_row,
                                   self._warange(lp), n)
                else:
                    hs = M.paged_prefill(self.cfg, meta, self.params,
                                         self.kv_pool, self._lay, slot, ids,
                                         seg, pos, bt_row, n)
                    self.state["length"][slot] = n
                    _reset_slot(self.state, slot, hs, n, self._lay)
            self.last_fill = dict(bucket=lp, prompt_len=n,
                                  cached_len=0, prefilled=n)
            self.fill_stats["prefill_tokens"] += n
            self.counts["full_prefills"] += 1
        else:
            s = n - c
            with tracing.span("serve:prefill", slot=slot,
                              prompt_len=n, bucket=s_b, cached_len=c,
                              paged=True):
                ids, seg, pos = self._prompt_window(prompt[c:], s_b, c)
                if self._lay is None:
                    _paged_prefill_suffix(
                        self.cfg, meta, self.params, arrays, self.state,
                        slot, bt_row, self._warange(c_b), c, ids, seg, pos,
                        s)
                else:
                    hs = M.paged_prefill_suffix(
                        self.cfg, meta, self.params, self.kv_pool, self._lay,
                        slot, bt_row, c, c_b, ids, seg, pos, s)
                    self.state["length"][slot] = c + s
                    _reset_slot(self.state, slot, hs, c + s, self._lay)
            self.last_fill = dict(bucket=s_b, prompt_len=n,
                                  cached_len=c, prefilled=s)
            self.fill_stats["prefill_tokens"] += s
            self.fill_stats["prefill_tokens_saved"] += c
            self.counts["suffix_prefills"] += 1

    # ------------------------------------------------------------------
    def generate_all(self, prompts: List[np.ndarray],
                     generator: Optional[torch.Generator] = None
                     ) -> List[FinishedSequence]:
        """Run the queue to completion; results in request order."""
        queue = list(enumerate(prompts))[::-1]  # pop() takes req 0 first
        results: Dict[int, FinishedSequence] = {}
        while queue or self.n_live:
            for slot in self.free_slots():
                if not queue:
                    break
                rid, p = queue.pop()
                self.fill_slot(slot, rid, p)
            self.decode_chunk(generator)
            for fs in self.harvest():
                results[fs.request_id] = fs
        return [results[i] for i in range(len(prompts))]


# ----------------------------------------------------------------------
# device pieces: functions over the state dict, updating it in place
# ----------------------------------------------------------------------
def _reset_slot(state, slot: int, hidden, plen: int, lay=None):
    """A freshly filled slot's per-slot fields (``hidden``: its last
    hidden state, over members each of its group's members' rows)."""
    if lay is None:
        state["last_hidden"][slot] = hidden
    else:
        M.set_hidden(state, lay, slot, hidden)
    state["prompt_len"][slot] = plen
    state["emitted"][slot] = 0
    state["active"][slot] = True
    state["unfinished"][slot] = True
    state["hit_eos"][slot] = False
    state["out_tokens"][slot] = 0
    state["out_logprobs"][slot] = 0.0
    state["spec_proposed"][slot] = 0
    state["spec_accepted"][slot] = 0


def _prefill_into_slot(cfg, params, state, slot: int, ids, seg, pos,
                       plen: int, lay=None):
    """Batch-1 prefill written into ``slot``'s cache rows: rows past the
    bucket are zeroed, the bucket's left padding is invalid."""
    if lay is not None:
        _reset_slot(state, slot, M.prefill_into_slot(
            cfg, params, lay, state, slot, ids, seg, pos), plen, lay)
        return
    hidden, pcache = T.prefill(cfg, params, ids, seg, pos)
    lp = ids.shape[1]
    cache = state["cache"]
    for name in ("k", "v"):
        cache[name][:, slot, :, :lp] = pcache[name][:, 0, :, :lp]
        cache[name][:, slot, :, lp:] = 0
    cache["valid"][slot] = False
    cache["valid"][slot, :lp] = seg[0] != 0
    cache["length"][slot] = lp  # write index
    _reset_slot(state, slot, hidden[0, -1], plen)


def _extend_rows(cfg, params, k_all, v_all, valid0, tokens, positions,
                 rows, tok_mask):
    """Run ``m`` new tokens per stream through the transformer in ONE
    forward against existing KV rows: the primitive under suffix
    prefill (after a prefix-cache donor) and speculative verify (the
    committed token + k drafts).

    k_all/v_all: [nl, B, nkv, S, hd] rows, written in place.
    valid0: [B, S] validity before the new tokens.
    tokens/positions/rows: [B, m]; ``rows`` are the rows the new tokens
    write (clamped to S-1 by the caller). tok_mask: [B, m]: masked
    lanes write no KV; their hidden outputs are garbage.

    Returns hidden [B, m, H] after the final norm. Attention is plain
    PyTorch (fp32 scores masked per query: rows valid before the call
    plus the new rows of lanes <= the query's lane), as the JAX package
    computes it with an einsum outside any Pallas kernel."""
    x = T._embed(cfg, params, tokens.long(), positions)
    cos, sin = T._rotary_tables(cfg, positions)
    qmask = M.query_mask(cfg, dict(valid=valid0), rows, tok_mask)
    cache = dict(k=k_all, v=v_all)
    for li, lp in enumerate(T.layer_views(params["blocks"], cfg.n_layers)):
        q, k, v = T._attn_in(cfg, lp, x, cos, sin)
        M.write_rows(k_all[li], rows, k, tok_mask)
        M.write_rows(v_all[li], rows, v, tok_mask)
        attn = M.attend(cfg, li, q, cache, qmask)
        x, _ = T._attn_out(cfg, lp, x, attn.to(x.dtype))
    return T._norm(cfg, x, params["ln_f"]["scale"],
                   params["ln_f"].get("bias"))


def _prefill_suffix_into_slot(cfg, params, state, slot: int, donor_k,
                              donor_v, c: int, ids, seg, pos, s: int):
    """Partial prefill for a host prefix-cache hit: the donor seeds a
    local window's rows [0, c_b) (valid below ``c``), the left-padded
    suffix runs ``_extend_rows`` against it at rows [c_b, c_b + s_b), and
    the window is written into ``slot``'s first c_b + s_b cache rows."""
    nl, nkv, c_b, hd = donor_k.shape
    s_b = ids.shape[1]
    win = c_b + s_b
    cache = state["cache"]
    kdt = cache["k"].dtype
    dev = ids.device
    local_k = torch.zeros((nl, 1, nkv, win, hd), dtype=kdt, device=dev)
    local_v = torch.zeros_like(local_k)
    local_k[:, 0, :, :c_b] = donor_k
    local_v[:, 0, :, :c_b] = donor_v
    valid0 = torch.zeros((1, win), dtype=torch.bool, device=dev)
    valid0[0, :c] = True
    rows = (c_b + torch.arange(s_b, dtype=torch.int32, device=dev))[None, :]
    tok_mask = seg != 0
    hidden = _extend_rows(cfg, params, local_k, local_v, valid0, ids, pos,
                          rows, tok_mask)
    cache["k"][:, slot, :, :win] = local_k[:, 0]
    cache["v"][:, slot, :, :win] = local_v[:, 0]
    cache["valid"][slot] = False
    cache["valid"][slot, :c] = True
    cache["valid"][slot, c_b:win] = tok_mask[0]
    cache["length"][slot] = win  # write index
    _reset_slot(state, slot, hidden[0, -1], c + s)


def _prefill_suffix_members(cfg, mp, lay, state, slot: int, dk, dv, c: int,
                            c_b: int, ids, seg, pos, s: int):
    """``_prefill_suffix_into_slot`` over members, in the slot's own
    cache row: the donor's first ``c`` rows seed it, the left-padded
    suffix runs ``extend_rows`` on the owning group at rows [c_b, c_b +
    s_b)."""
    caches = state["cache"]
    M.write_donor(cfg, lay, caches, slot, dk, dv, c)
    s_b = ids.shape[1]
    rows = (c_b + torch.arange(s_b, dtype=torch.int32,
                               device=ids.device))[None, :]
    tok_mask = seg != 0
    g, r = lay.group_of(slot)
    hidden = M.extend_rows(cfg, mp, lay, M.row_views(lay, caches, slot), ids,
                           pos, rows, tok_mask, [(g, 0, 1)], s_b)
    M.set_valid(lay, caches, slot, c_b, tok_mask[0])
    for i in lay.members(g):
        caches[i]["length"][r] = c_b + s_b  # write index
    _reset_slot(state, slot, hidden.hs[g], c + s, lay)


# ----------------------------------------------------------------------
# paged pieces: gather the live window from the pool, run the dense
# compute above on it, scatter the written rows back. The pool changes
# where rows live, not how they are used.
# ----------------------------------------------------------------------
def _paged_window(cfg, meta, pool, bt, warange, length):
    """(flat pool rows [B, win], dense cache dict over the window): row
    ``j < length[b]`` of sequence ``b`` is valid (windows are
    compacted: token ``j`` lives at window row ``j``)."""
    rows = _kvp.window_rows(bt, warange, meta.block_len)
    k, v = _kvp.pool_gather(meta, pool, rows, T.dtype_of(cfg.compute_dtype))
    valid = warange[None, :] < length[:, None]
    return rows, dict(k=k, v=v, valid=valid, length=length.clone())


def _scatter_written(meta, pool, rows, cache, len0, m, mask_extra):
    """Write back the window rows ``[len0, len0 + m)`` per sequence,
    masked to ``mask_extra`` and to the window."""
    nl, b, nkv, win, hd = cache["k"].shape
    j = torch.arange(m, dtype=torch.int32, device=rows.device)[None, :]
    want = len0[:, None] + j
    wrows = want.clamp(0, win - 1).long()
    mask = (want < win) & mask_extra
    idx = wrows[None, :, None, :, None].expand(nl, b, nkv, m, hd)
    kw = cache["k"].gather(3, idx)
    vw = cache["v"].gather(3, idx)
    flat = rows.gather(1, wrows)
    _kvp.pool_scatter(meta, pool, flat, kw, vw, mask)


def _windowed_state(cfg, meta, pool, state, bt, warange, lay):
    """(flat pool rows or None, the state over dense window caches): one
    cache, or over members ``inflight_members.paged_window``'s."""
    if lay is None:
        rows, cache = _paged_window(cfg, meta, pool.arrays(), bt, warange,
                                    state["length"])
    else:
        rows, cache = None, M.paged_window(cfg, meta, pool, lay, bt,
                                           warange.shape[0], state["length"])
    st = {k: v for k, v in state.items() if k != "length"}
    st["cache"] = cache
    return rows, st


def _written_back(meta, pool, lay, rows, cache, bt, win, len0, m, mask):
    """Window rows ``[len0, len0 + m)`` where ``mask`` back into the pool;
    returns the caches' new write indices."""
    if lay is None:
        _scatter_written(meta, pool.arrays(), rows, cache, len0, m, mask)
        return cache["length"]
    M.scatter_written(meta, pool, lay, cache, bt, win, len0, m, mask)
    return M.lengths(lay, cache)


def _paged_decode_chunk(cfg, g, eos, pad, chunk, meta, params, pool, state,
                        bt, warange, generator, lay=None):
    """gather -> dense ``_decode_chunk`` -> scatter the <= ``chunk`` new
    rows of each slot back into the pool -> (state, steps taken)."""
    rows, st = _windowed_state(cfg, meta, pool, state, bt, warange, lay)
    steps = _decode_chunk(cfg, g, eos, pad, chunk, params, st, generator)
    cache = st.pop("cache")
    len0 = state["length"]
    len1 = cache["length"] if lay is None else M.lengths(lay, cache)
    j = torch.arange(chunk, dtype=torch.int32, device=len0.device)[None, :]
    st["length"] = _written_back(meta, pool, lay, rows, cache, bt,
                                 warange.shape[0], len0, chunk,
                                 j < (len1 - len0)[:, None])
    return st, steps


def _paged_verify(cfg, g, eos, k_spec, meta, params, pool, state, bt,
                  warange, drafts, lay=None):
    """gather -> dense ``_verify_chunk`` -> scatter the round's <= k+1
    rows of each live slot back."""
    live = (state["active"] & state["unfinished"]
            & (state["emitted"] < g.max_new_tokens))
    rows, st = _windowed_state(cfg, meta, pool, state, bt, warange, lay)
    _verify_chunk(cfg, g, eos, k_spec, params, st, drafts, lay)
    cache = st.pop("cache")
    st["length"] = _written_back(meta, pool, lay, rows, cache, bt,
                                 warange.shape[0], state["length"],
                                 1 + k_spec, live[:, None])
    return st


def _paged_prefill(cfg, meta, params, pool, state, slot: int, ids, seg,
                   pos, bt_row, warange, n: int):
    """Full prefill into pool blocks: the dense path's left-padded,
    bucketed ``T.prefill``, its rows compacted on scatter (window row
    ``p`` holds token ``p``)."""
    hidden, pcache = T.prefill(cfg, params, ids, seg, pos)
    lp = ids.shape[1]
    blen = meta.block_len
    # prefill put token p at row lp - n + p (left padding); strip it
    src = (warange + (lp - n)).clamp(0, pcache["k"].shape[3] - 1).long()
    kc = pcache["k"][:, 0].index_select(2, src)      # [nl, nkv, lp, hd]
    vc = pcache["v"][:, 0].index_select(2, src)
    wl = warange.long()
    rows = (bt_row[wl // blen].long() * blen + wl % blen)[None, :]
    _kvp.pool_scatter(meta, pool, rows, kc[:, None], vc[:, None],
                      (warange < n)[None, :])
    state["length"][slot] = n
    _reset_slot(state, slot, hidden[0, -1], n)


def _paged_prefill_suffix(cfg, meta, params, pool, state, slot: int,
                          bt_row, warange_c, c: int, ids, seg, pos, s: int):
    """Partial prefill after whole-block aliasing: the donor rows
    [0, c) are already in the slot's table (a refcount bump put them
    there); gather them into a local window, run the suffix through
    ``_extend_rows`` at window rows [c, c + s) and scatter only those
    rows back."""
    blen = meta.block_len
    c_b = warange_c.shape[0]
    s_b = ids.shape[1]
    cdt = T.dtype_of(cfg.compute_dtype)
    dev = ids.device
    wc = warange_c.long()
    drows = (bt_row[wc // blen].long() * blen + wc % blen)[None, :]
    dk, dv = _kvp.pool_gather(meta, pool, drows, cdt)
    nl, _, nkv, _, hd = dk.shape
    zeros = torch.zeros((nl, 1, nkv, s_b, hd), dtype=cdt, device=dev)
    local_k = torch.cat([dk, zeros], dim=3)
    local_v = torch.cat([dv, zeros], dim=3)
    valid0 = torch.zeros((1, c_b + s_b), dtype=torch.bool, device=dev)
    valid0[0, :c] = True
    lane = torch.arange(s_b, dtype=torch.int32, device=dev)
    wrow = (c + lane - (s_b - s)).clamp(0, c_b + s_b - 1)[None, :]
    tok_mask = seg != 0
    hidden = _extend_rows(cfg, params, local_k, local_v, valid0, ids, pos,
                          wrow, tok_mask)
    w = wrow.long()
    idx = w[None, :, None, :, None].expand(nl, 1, nkv, s_b, hd)
    kw = local_k.gather(3, idx)
    vw = local_v.gather(3, idx)
    flat = bt_row[w[0] // blen].long() * blen + w[0] % blen
    _kvp.pool_scatter(meta, pool, flat[None, :], kw, vw, tok_mask)
    state["length"][slot] = c + s
    _reset_slot(state, slot, hidden[0, -1], c + s)


def _suppress_eos(g, eos, logits, emitted_ahead):
    """EOS masked out where fewer than ``min_new_tokens`` tokens would
    be out; ``emitted_ahead`` has the shape of logits' leading axes."""
    if eos is None or g.min_new_tokens <= 0:
        return logits
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    sup = (emitted_ahead < g.min_new_tokens)[..., None] & (vocab == eos)
    return torch.where(sup, NEG_INF, logits)


def _verify_chunk(cfg, g, eos, k_spec, params, st, drafts, lay=None):
    """One speculative round, in place on ``st``: commit the greedy
    token from ``last_hidden`` (no forward needed), then verify the k
    drafts behind it in ONE ``_extend_rows`` forward. A draft is
    accepted iff it equals the argmax plain greedy decoding would have
    produced there, so the emitted stream equals plain greedy decoding
    token for token; a rejected tail is rolled back (its rows stay
    invalid, ``length`` advances by the emitted count only)."""
    nm = g.max_new_tokens
    m = 1 + k_spec
    cache = st["cache"]
    if lay is None:
        s_len, length = cache["valid"].shape[1], cache["length"]
    else:
        s_len, length = M.total_slots(lay, cache), M.lengths(lay, cache)
    b = drafts.shape[0]
    dev = drafts.device
    barr = torch.arange(b, device=dev)
    emitted = st["emitted"]

    live = st["active"] & st["unfinished"] & (emitted < nm)
    logits0 = _suppress_eos(
        g, eos, T.lm_logits(cfg, params, st["last_hidden"]).float(), emitted)
    f0 = logits0.argmax(-1).to(torch.int32)
    logp0 = torch.log_softmax(logits0, -1).gather(-1, f0[:, None].long())[:, 0]

    tokens_seq = torch.cat([f0[:, None], drafts.to(torch.int32)], dim=1)
    j = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    allowed = (nm - emitted).clamp(0, m)
    write_mask = live[:, None] & (j < allowed[:, None])
    rows = (length[:, None] + j).clamp(max=s_len - 1)
    positions = st["prompt_len"][:, None] + emitted[:, None] + j

    if lay is None:
        hidden = _extend_rows(cfg, params, cache["k"], cache["v"],
                              cache["valid"], tokens_seq, positions, rows,
                              write_mask)
    else:
        hidden = M.extend_rows(cfg, params, lay, cache, tokens_seq, positions,
                               rows, write_mask, M.group_rows(lay), b * m)
    # candidate j is drawn with emitted + j + 1 tokens out
    logits = _suppress_eos(g, eos, T.lm_logits(cfg, params, hidden).float(),
                           emitted[:, None] + j + 1)
    cand = logits.argmax(-1).to(torch.int32)                   # [B, m]
    # draft i (tokens_seq[:, i+1]) is scored by position i's logits
    logp_steps = torch.log_softmax(logits[:, :-1], -1).gather(
        -1, tokens_seq[:, 1:, None].long())[:, :, 0]           # [B, k]
    draft_ok = tokens_seq[:, 1:] == cand[:, :-1]
    acc = torch.cumprod(draft_ok.to(torch.int32), dim=1)
    n_emit = torch.minimum(acc.sum(1).to(torch.int32) + 1, allowed)
    n_emit = torch.where(live, n_emit, 0)
    hit_now = torch.zeros((b,), dtype=torch.bool, device=dev)
    if eos is not None:
        is_eos = (tokens_seq == eos) & (j < n_emit[:, None])
        hit_now = is_eos.any(dim=1)
        first_eos = is_eos.to(torch.int32).argmax(dim=1).to(torch.int32)
        n_emit = torch.where(hit_now, torch.minimum(n_emit, first_eos + 1),
                             n_emit)

    emit_mask = j < n_emit[:, None]
    lps = torch.cat([logp0[:, None], logp_steps], dim=1)
    # emitted lanes go to out[emitted : emitted + n_emit] as a gather +
    # where over the whole output row (no scatter of clamped lanes)
    p = torch.arange(nm, dtype=torch.int32, device=dev)[None, :]
    rel = p - emitted[:, None]
    take = (rel >= 0) & (rel < n_emit[:, None])
    gidx = rel.clamp(0, m - 1).long()
    st["out_tokens"] = torch.where(take, tokens_seq.gather(1, gidx),
                                   st["out_tokens"])
    st["out_logprobs"] = torch.where(take, lps.gather(1, gidx),
                                     st["out_logprobs"])
    new_emitted = emitted + n_emit
    st["unfinished"] = st["unfinished"] & ~hit_now & (new_emitted < nm)
    st["hit_eos"] = st["hit_eos"] | hit_now
    kept = ((rows[:, :, None] == torch.arange(s_len, device=dev)[None, None])
            & emit_mask[:, :, None]).any(dim=1)
    last = (n_emit - 1).clamp(min=0)
    if lay is None:
        cache["valid"] = cache["valid"] | kept
        cache["length"] = cache["length"] + n_emit
        st["last_hidden"] = torch.where(
            live[:, None], hidden[barr, last.long()], st["last_hidden"])
    else:
        M.commit(lay, cache, kept, n_emit)
        st["last_hidden"] = M.select_hidden(lay, hidden, last, live,
                                            st["last_hidden"])
    st["spec_proposed"] = st["spec_proposed"] + torch.where(
        live, k_spec, 0).to(torch.int32)
    st["spec_accepted"] = st["spec_accepted"] + (n_emit - 1).clamp(min=0)
    st["emitted"] = new_emitted


def _decode_chunk(cfg, g, eos, pad, chunk, params, st, generator):
    """Up to ``chunk`` decode steps over every slot, in place on ``st``
    (inactive and finished slots step on pad tokens and record nothing;
    ``decode_step`` drops their writes once they pass the cache). Each
    step first reads whether any slot is live (one host read) and stops
    when none is. Returns the steps taken."""
    nm = g.max_new_tokens
    n = st["emitted"].shape[0]
    rows = torch.arange(n, device=st["emitted"].device)
    steps = 0
    for _ in range(chunk):
        live = st["active"] & st["unfinished"] & (st["emitted"] < nm)
        if not bool(live.any()):
            break
        steps += 1
        logits = _suppress_eos(
            g, eos, T.lm_logits(cfg, params, st["last_hidden"]).float(),
            st["emitted"])
        if g.greedy:
            warped = logits
            tokens = warped.argmax(-1).to(torch.int32)
        else:
            warped = top_k_top_p_logits(logits / g.temperature, g.top_k,
                                        g.top_p)
            tokens = categorical(warped, generator).to(torch.int32)
        logprob = torch.log_softmax(warped, -1).gather(
            -1, tokens[:, None].long())[:, 0]
        tokens = torch.where(live, tokens, pad)
        idx = st["emitted"].clamp(max=nm - 1).long()
        st["out_tokens"][rows, idx] = torch.where(
            live, tokens, st["out_tokens"][rows, idx])
        st["out_logprobs"][rows, idx] = torch.where(
            live, logprob, st["out_logprobs"][rows, idx])
        emitted = st["emitted"] + live.to(torch.int32)
        unfinished, hit_eos = st["unfinished"], st["hit_eos"]
        if eos is not None:
            hit_eos = hit_eos | (live & (tokens == eos))
            unfinished = unfinished & (~live | (tokens != eos))
        unfinished = unfinished & (emitted < nm)
        pos = st["prompt_len"] + st["emitted"]
        hidden, cache = T.decode_step(cfg, params, st["cache"], tokens, pos)
        st.update(cache=cache, last_hidden=hidden, emitted=emitted,
                  unfinished=unfinished, hit_eos=hit_eos)
    return steps
