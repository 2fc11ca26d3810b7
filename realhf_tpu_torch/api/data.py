"""The universal data currency: packed variable-length sequence batches.

`SequenceSample` holds named 1D-packed arrays with per-key nested
sequence lengths and supports gather / select / update. Host-side
arrays are NumPy; engines move them to the device.

Also provides the dataset registry, dataset spec/loading helpers, and
the packed dataloader.
"""

import contextlib
import dataclasses
import json
import random as _random
from typing import Any, Callable, Dict, Hashable, List, Optional, Set, Tuple

import numpy as np

from realhf_tpu_torch.base import datapack, logging

logger = logging.getLogger("data_api")


@dataclasses.dataclass
class SequenceSplitSpec:
    """Contiguous batch partition boundaries: (start, end) per part."""
    partitions: List[Tuple[int, int]]


_VALIDATION_ENABLED = True


class SequenceSample:
    """A batch of named, packed, variable-length sequences.

    See reference ``data_api.py:96-596`` for the full design discussion.
    Invariants:
      - ``ids`` are unique per batch element;
      - ``seqlens[k]`` is a list (batch) of lists (sequences per element)
        of ints;
      - ``data[k]`` is a single array of shape
        ``(sum of all seqlens[k], *trailing_shapes[k])`` or None;
      - a sample with ``data=None`` is a metadata-only view that travels
        over the control plane.
    """

    def __init__(self, keys, trailing_shapes, dtypes, ids, seqlens,
                 data=None, metadata=None):
        self.keys: Set[str] = set(keys)
        self.trailing_shapes: Dict[str, Optional[Tuple]] = dict(trailing_shapes)
        self.dtypes: Dict[str, Optional[np.dtype]] = dict(dtypes)
        self.ids: List[Hashable] = list(ids)
        self.seqlens: Dict[str, List[List[int]]] = dict(seqlens)
        self.data: Optional[Dict[str, Optional[np.ndarray]]] = data
        self.metadata: Dict[str, List[Any]] = dict(metadata) if metadata else {}
        if _VALIDATION_ENABLED:
            self._validate()

    def _validate(self):
        if len(self.ids) != len(set(self.ids)):
            raise ValueError(f"IDs contain duplicates: {self.ids}")
        bs = len(self.ids)
        for k, lens in self.seqlens.items():
            if len(lens) != bs:
                raise ValueError(
                    f"seqlens[{k}] has {len(lens)} entries, expected {bs}.")
            for lens_ in lens:
                if not isinstance(lens_, list) or not all(
                        isinstance(x, int) for x in lens_):
                    raise ValueError(
                        f"seqlens[{k}] must be a list of lists of ints, got {lens}.")
        if self.keys != set(self.seqlens) or self.keys != set(
                self.trailing_shapes) or self.keys != set(self.dtypes):
            raise KeyError(
                f"Key mismatch: keys={self.keys}, seqlens={set(self.seqlens)}, "
                f"trailing_shapes={set(self.trailing_shapes)}, dtypes={set(self.dtypes)}")
        if self.data is not None:
            if self.keys != set(self.data):
                raise KeyError(f"Data keys {set(self.data)} != keys {self.keys}")
            for k, v in self.data.items():
                if v is None:
                    continue
                want = (sum(sum(l) for l in self.seqlens[k]),
                        *tuple(self.trailing_shapes[k]))
                if tuple(v.shape) != want:
                    raise ValueError(
                        f"Key {k}: data shape {v.shape} != expected {want}.")
                if np.dtype(v.dtype) != np.dtype(self.dtypes[k]):
                    raise ValueError(
                        f"Key {k}: dtype {v.dtype} != configured {self.dtypes[k]}.")

    @classmethod
    @contextlib.contextmanager
    def disable_validation(cls):
        global _VALIDATION_ENABLED
        prev = _VALIDATION_ENABLED
        _VALIDATION_ENABLED = False
        try:
            yield
        finally:
            _VALIDATION_ENABLED = prev

    # ------------------------------------------------------------------
    @property
    def bs(self) -> int:
        return len(self.ids)

    def total_len(self, key: str) -> int:
        return sum(sum(l) for l in self.seqlens[key])

    @classmethod
    def gather(cls, samples: List["SequenceSample"],
               keys: Optional[List[str]] = None) -> "SequenceSample":
        """Concatenate batches (reference ``data_api.py:269``)."""
        if not samples:
            raise ValueError("Cannot gather an empty list of samples.")
        keys = set(keys) if keys is not None else samples[0].keys
        seqlens = {k: sum([s.seqlens[k] for s in samples], []) for k in keys}
        if samples[0].data is not None:
            data = {
                k: (np.concatenate([s.data[k] for s in samples], axis=0)
                    if samples[0].data[k] is not None else None)
                for k in keys
            }
        else:
            data = None
        ids = sum([s.ids for s in samples], [])
        metadata = {k: sum([s.metadata[k] for s in samples], [])
                    for k in samples[0].metadata}
        with cls.disable_validation():
            return cls(
                keys=keys,
                trailing_shapes={k: samples[0].trailing_shapes[k] for k in keys},
                dtypes={k: samples[0].dtypes[k] for k in keys},
                ids=ids, seqlens=seqlens, data=data, metadata=metadata)

    def get_split_spec(self, k: int, key: Optional[str] = None,
                       min_size: int = 1) -> SequenceSplitSpec:
        """A token-balanced contiguous partition into k parts, by the
        key with the most tokens unless ``key`` is given."""
        key = key or max(self.keys, key=self.total_len)
        lens = [sum(l) for l in self.seqlens[key]]
        return SequenceSplitSpec(
            partitions=datapack.min_abs_diff_partition(lens, k, min_size))

    def split_with_spec(self, spec: SequenceSplitSpec
                        ) -> List["SequenceSample"]:
        samples = []
        offsets = {k: 0 for k in self.keys}
        for start, end in spec.partitions:
            seqlens = {k: l[start:end] for k, l in self.seqlens.items()}
            chunk = {k: sum(sum(l) for l in v) for k, v in seqlens.items()}
            if self.data is not None:
                data = {k: (v[offsets[k]:offsets[k] + chunk[k]]
                            if v is not None else None)
                        for k, v in self.data.items()}
            else:
                data = None
            for k in self.keys:
                offsets[k] += chunk[k]
            with self.disable_validation():
                samples.append(SequenceSample(
                    keys=self.keys,
                    trailing_shapes=self.trailing_shapes,
                    dtypes=self.dtypes,
                    ids=self.ids[start:end],
                    seqlens=seqlens,
                    data=data,
                    metadata={k: v[start:end]
                              for k, v in self.metadata.items()}))
        return samples

    def split(self, k: int, key: Optional[str] = None,
              min_size: int = 1) -> List["SequenceSample"]:
        """k token-balanced contiguous parts of this batch."""
        return self.split_with_spec(self.get_split_spec(k, key, min_size))

    def select(self, keys: List[str]) -> "SequenceSample":
        """A view holding only the given keys."""
        keys = set(keys)
        missing = keys - self.keys
        if missing:
            raise KeyError(f"Missing keys: {missing}; available: {self.keys}")
        with self.disable_validation():
            return SequenceSample(
                keys=keys,
                trailing_shapes={k: self.trailing_shapes[k] for k in keys},
                dtypes={k: self.dtypes[k] for k in keys},
                ids=self.ids,
                seqlens={k: self.seqlens[k] for k in keys},
                data=None if self.data is None else {
                    k: self.data[k] for k in keys},
                metadata=self.metadata)

    def update_(self, other: "SequenceSample"):
        """Merge keys produced by an MFC (reference ``data_api.py:441``)."""
        assert self.ids == other.ids, (self.ids, other.ids)
        self.keys = self.keys | other.keys
        self.trailing_shapes.update(other.trailing_shapes)
        self.dtypes.update(other.dtypes)
        self.seqlens.update(other.seqlens)
        if self.data is not None and other.data is not None:
            self.data.update(other.data)
        self.metadata.update(other.metadata)

    def remap_keys_(self, remap: Dict[str, str]):
        for k in list(self.keys):
            if k in remap:
                nk = remap[k]
                self.seqlens[nk] = self.seqlens.pop(k)
                self.trailing_shapes[nk] = self.trailing_shapes.pop(k)
                self.dtypes[nk] = self.dtypes.pop(k)
                if self.data is not None:
                    self.data[nk] = self.data.pop(k)
        self.keys = {remap.get(k, k) for k in self.keys}

    # ------------------------------------------------------------------
    _KEYS_LEN_1 = {
        "seq_no_eos_mask", "greedy_seq_no_eos_mask", "loss_mask", "rewards",
        "greedy_rewards", "pos_input_lens", "group_factor", "seq_len",
    }
    _KEYS_LEN_FULL = {
        "input_ids", "packed_seq", "seq", "packed_logits_mask", "logits_mask",
        "prompt_mask", "greedy_prompt_mask", "packed_input_ids",
        "greedy_packed_input_ids", "values", "packed_prompts",
    }
    _KEYS_LEN_MINUS_1 = {
        "packed_logprobs", "logprobs", "packed_ref_logprobs", "ref_logprobs",
        "old_logp", "ref_logp", "advantages", "ppo_loss_mask", "kl_rewards",
        "returns", "staleness", "dense_rewards",
    }

    @classmethod
    def _resolve_seqlen_from_key(cls, key: str,
                                 seqlens: List[int]) -> List[List[int]]:
        if key in cls._KEYS_LEN_1:
            return [[1] for _ in seqlens]
        if key in cls._KEYS_LEN_FULL:
            return [[l] for l in seqlens]
        if key in cls._KEYS_LEN_MINUS_1:
            return [[l - 1] for l in seqlens]
        raise NotImplementedError(
            f"Cannot resolve seqlens for key `{key}`; construct the "
            "SequenceSample explicitly instead of using from_default.")

    @classmethod
    def from_default(cls, seqlens: List[int], ids: List[Hashable],
                     data: Dict[str, Optional[np.ndarray]],
                     metadata: Optional[Dict[str, List[Any]]] = None
                     ) -> "SequenceSample":
        """Build a sample where every element has ONE sequence whose
        length per key follows the standard key-naming rules
        (reference ``data_api.py:500``)."""
        metadata = metadata or {}
        for k, v in metadata.items():
            if not isinstance(v, list) or len(v) != len(seqlens):
                raise ValueError(
                    f"Metadata `{k}` must be a list of len {len(seqlens)}: {v}")
        if seqlens and isinstance(seqlens[0], list):
            assert all(len(s) == 1 for s in seqlens)
            seqlens = [s[0] for s in seqlens]
        keys = set(data.keys())
        return cls(
            keys=keys,
            ids=ids,
            seqlens={k: cls._resolve_seqlen_from_key(k, seqlens) for k in keys},
            trailing_shapes={k: (tuple(data[k].shape[1:])
                                 if data[k] is not None else None)
                             for k in keys},
            dtypes={k: (data[k].dtype if data[k] is not None else None)
                    for k in keys},
            data=data,
            metadata=metadata)

    def __repr__(self):
        return (f"SequenceSample(bs={self.bs}, keys={sorted(self.keys)}, "
                f"meta_only={self.data is None})")


# ----------------------------------------------------------------------
# Dataset registry and loading utilities.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DatasetUtility:
    """Context handed to dataset constructors (reference util object):
    seed, dp rank/size for sharding, and the HF tokenizer."""
    seed: int
    dp_rank: int
    world_size: int
    tokenizer: Any


ALL_DATASET_CLASSES: Dict[str, Callable] = {}


def register_dataset(name: str, dataset_cls: Callable):
    if name in ALL_DATASET_CLASSES:
        raise ValueError(f"Dataset {name} already registered.")
    ALL_DATASET_CLASSES[name] = dataset_cls


def make_dataset(cfg, seed: int, dp_rank: int, world_size: int,
                 tokenizer_or_path: Any):
    """Instantiate a registered dataset (reference ``data_api.py:671``)."""
    from realhf_tpu_torch.api.config import DatasetAbstraction
    if isinstance(cfg, str):
        cfg = DatasetAbstraction(type_=cfg)
    tokenizer = (load_hf_tokenizer(tokenizer_or_path)
                 if isinstance(tokenizer_or_path, str) else tokenizer_or_path)
    util = DatasetUtility(seed=seed, dp_rank=dp_rank, world_size=world_size,
                          tokenizer=tokenizer)
    return ALL_DATASET_CLASSES[cfg.type_](util=util, **cfg.args)


def load_hf_tokenizer(path: str, fast: bool = True, padding_side: str = "left"):
    raise NotImplementedError(
        "Loading a Hugging Face tokenizer is deferred to the checkpoint-IO "
        "slice of the port; pass a tokenizer object (ExperimentSpec."
        "tokenizer) instead.")


def require_record_fields(records: List[Dict], required: Tuple[str, ...],
                          loader: str, hint: str = "") -> List[Dict]:
    """Validate loaded records up front so a malformed file fails with
    the offending record named instead of a bare ``KeyError`` deep in
    tokenization/collation. ``required`` fields must be present and
    non-None on every record."""
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            raise ValueError(
                f"{loader}: record {i} is {type(rec).__name__}, expected "
                f"an object with fields {list(required)}.{hint}")
        missing = [f for f in required if rec.get(f) is None]
        if missing:
            ident = rec.get("id", f"index {i}")
            raise ValueError(
                f"{loader}: record {ident!r} is missing required field"
                f"{'s' if len(missing) > 1 else ''} {missing} "
                f"(present: {sorted(rec)}).{hint}")
    return records


def load_shuffle_split_dataset(util: DatasetUtility, dataset_path: str,
                               dataset_builder: Optional[Callable[[], List[Dict]]] = None
                               ) -> List[Dict]:
    """Load JSON/JSONL records, shuffle with the experiment seed, and
    take this DP rank's contiguous shard (reference ``data_api.py:631``)."""
    if dataset_path:
        if dataset_path.endswith(".jsonl"):
            with open(dataset_path) as f:
                records = [json.loads(line) for line in f if line.strip()]
        elif dataset_path.endswith(".json"):
            with open(dataset_path) as f:
                records = json.load(f)
        else:
            raise NotImplementedError(f"Unknown dataset format: {dataset_path}")
    else:
        assert dataset_builder is not None
        records = dataset_builder()
    if any("id" not in d for d in records):
        logger.warning("Dataset entries missing unique `id`; assigning "
                       "sequential ids.")
        for i, d in enumerate(records):
            d["id"] = i
    ids = [d["id"] for d in records]
    if len(set(ids)) != len(ids):
        raise ValueError("Dataset ids are not unique.")
    rng = _random.Random(util.seed)
    indices = list(range(len(records)))
    rng.shuffle(indices)
    shard = np.array_split(indices, util.world_size)[util.dp_rank]
    return [records[i] for i in shard]


class PackedDataLoader:
    """Iterates a map-style dataset in shuffled fixed-size batches of
    SequenceSamples gathered into one packed batch (reference
    ``data_api.py:761``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = list(range(n))
        if self.shuffle:
            _random.Random(self.seed + self.epoch).shuffle(order)
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield SequenceSample.gather([self.dataset[j] for j in idx])
        self.epoch += 1
