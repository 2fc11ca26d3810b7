"""Testing utilities shipped with the package (picklable across
processes): a word-hash tokenizer and a model-free slot backend."""


class IntegerTokenizer:
    """Deterministic word-hash tokenizer for tests and random-weight
    runs: no vocabulary files and no network."""

    pad_token_id = 0
    eos_token_id = 1
    eos_token = " zEOSz"
    padding_side = "left"

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size

    def __call__(self, texts, truncation=False, max_length=None,
                 padding=False, return_length=False,
                 return_attention_mask=False, **kw):
        ids = [[2 + (sum(map(ord, w)) % self.vocab_size)
                for w in t.split()] for t in texts]
        if truncation and max_length:
            ids = [x[:max_length] for x in ids]
        out = {"input_ids": ids}
        if return_length:
            out["length"] = [len(x) for x in ids]
        return out

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))


class FakeSlotBackend:
    """Deterministic slot backend implementing the
    ``engine.inflight.InflightBatchingGenerator`` step API without a
    model: ``prompt[0]`` encodes how many tokens the sequence needs,
    and every ``decode_chunk`` advances each live slot by up to
    ``chunk`` tokens. Used by the scheduler tests, where many serve
    iterations must run in milliseconds.

    With ``prefix_capable=True`` it also implements the prefix-cache
    extensions (``supports_prefix_fill`` / ``fill_slot(cached_len,
    prefix_kv)`` / ``harvest(export_kv=True)``): exported KV blocks
    are tiny ``[1, 1, seq_len, 1]`` float32 arrays (4 bytes per
    token+layer-head), enough to drive radix-tree byte accounting
    without a model.

    With ``kv_pool=`` (a ``KVPool.host_only(...)``) it grows the
    PAGED surface the scheduler admission/OOM path keys on --
    ``kv_pool_stats`` / ``admission_blocks_needed`` /
    ``fill_slot(cached_blocks=...)`` / ``harvest(export_blocks=True)``
    -- with the REAL allocator arithmetic (alloc at fill, lazy growth
    per decode chunk raising ``KVPoolOOM``, refcounted aliasing,
    free at release), so scheduler tests exercise pool backpressure
    without a model."""

    def __init__(self, n_slots: int = 2, chunk: int = 4,
                 max_prompt_len: int = 64,
                 prefix_capable: bool = False, kv_pool=None):
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_prompt_len = max_prompt_len
        self.supports_prefix_fill = prefix_capable
        self.kv_pool = kv_pool
        self.params = "v0"
        self._slots = {}  # slot -> [int_id, need, got]
        self._prompts = {}  # slot -> prompt copy (prefix mode)
        self._blocks = {}  # slot -> block id list (pool mode)
        self._plens = {}  # slot -> prompt length (pool mode)
        self.fills = []  # (slot, int_id, cached_len) fill audit trail

    def free_slots(self):
        return [s for s in range(self.n_slots) if s not in self._slots]

    def fill_slot(self, slot, int_id, prompt, cached_len=0,
                  prefix_kv=None, cached_blocks=None):
        if len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} > {self.max_prompt_len}")
        if self.kv_pool is not None:
            pool = self.kv_pool
            c = max(0, min(int(cached_len), len(prompt) - 1))
            c -= c % pool.block_len
            n_alias = c // pool.block_len
            own = pool.alloc(pool.blocks_for_rows(len(prompt))
                             - n_alias)  # may raise KVPoolOOM
            try:
                alias = [int(b)
                         for b in (cached_blocks or [])[:n_alias]]
                if alias:
                    pool.incref(alias)
            except BaseException:
                # mirror the real backend: a bad alias chain must not
                # leak the fresh blocks (nothing references them yet)
                pool.free(own)
                raise
            self._blocks[slot] = alias + own
            self._plens[slot] = len(prompt)
        self._slots[slot] = [int_id, int(prompt[0]), 0]
        if self.supports_prefix_fill or self.kv_pool is not None:
            import numpy as np
            self._prompts[slot] = np.asarray(prompt).copy()
        self.fills.append((slot, int_id, int(cached_len)))

    def decode_chunk(self, generator=None):
        if self.kv_pool is not None:
            pool = self.kv_pool
            for slot, (_, need, got) in self._slots.items():
                rows = self._plens[slot] + min(need, got + self.chunk)
                grow = pool.blocks_for_rows(rows) \
                    - len(self._blocks[slot])
                if grow > 0:
                    self._blocks[slot].extend(
                        pool.alloc(grow))  # may raise KVPoolOOM
        for v in self._slots.values():
            v[2] = min(v[1], v[2] + self.chunk)

    def harvest(self, export_kv=False, export_blocks=False):
        import numpy as np

        from realhf_tpu_torch.engine.inflight import FinishedSequence
        out = []
        for slot, (i, need, got) in list(self._slots.items()):
            if got >= need:
                fs = FinishedSequence(
                    request_id=i, tokens=np.arange(got),
                    logprobs=np.zeros(got), no_eos=True)
                if export_kv and self.supports_prefix_fill:
                    n = len(self._prompts[slot]) + got
                    fs.kv = (np.zeros((1, 1, n, 1), np.float32),
                             np.zeros((1, 1, n, 1), np.float32))
                if export_blocks and self.kv_pool is not None:
                    blocks = tuple(self._blocks[slot])
                    self.kv_pool.incref(blocks)
                    fs.blocks = blocks
                    fs.n_rows = self._plens[slot] + got
                out.append(fs)
                self.release_slot(slot)
        return out

    def release_slot(self, slot):
        self._slots.pop(slot, None)
        self._prompts.pop(slot, None)
        self._plens.pop(slot, None)
        if self.kv_pool is not None and slot in self._blocks:
            self.kv_pool.free(self._blocks.pop(slot))

    def kv_pool_stats(self):
        s = self.kv_pool.stats()
        s["rows_in_use"] = sum(
            self._plens[slot] + got
            for slot, (_, _, got) in self._slots.items())
        return s

    def admission_blocks_needed(self, prompt_len, cached_len=0):
        pool = self.kv_pool
        c = max(0, min(int(cached_len), int(prompt_len) - 1))
        c -= c % pool.block_len
        return (pool.blocks_for_rows(prompt_len)
                - c // pool.block_len + 1)

    def swap_params(self, p):
        self.params = p

    def snapshot_slot(self, slot):
        import numpy as np
        _, _, got = self._slots[slot]
        return np.arange(got), np.zeros(got)

    @property
    def n_live(self):
        return len(self._slots)
