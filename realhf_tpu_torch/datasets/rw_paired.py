"""Paired positive/negative answer dataset for reward modeling and DPO.

JSONL records with "id", "prompt", "pos_answers" and "neg_answers"
(paired one to one). Each item packs up to ``max_pairs_per_prompt``
interleaved (pos, neg) full sequences into ``packed_input_ids``, with
the prompt's length (the answer masks of DPO start after it). Which
pairs an item takes is drawn from a ``np.random.RandomState`` seeded
with the experiment seed, so the same file and seed give the same
pairs.
"""

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.base import logging

logger = logging.getLogger("RewardPairedDataset")


class RewardModelingPairedDataset:

    def __init__(self, util: data_api.DatasetUtility, max_length: int,
                 max_pairs_per_prompt: int = 2,
                 dataset_path: Optional[str] = None,
                 dataset_builder: Optional[Callable[[], List[Dict]]] = None):
        self._util = util
        tokenizer = util.tokenizer
        self.max_pairs_per_prompt = max_pairs_per_prompt
        self.rng = np.random.RandomState(seed=util.seed)

        records = data_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder)
        data_api.require_record_fields(
            records, ("prompt", "pos_answers", "neg_answers"),
            "RewardModelingPairedDataset",
            hint=" Expected JSONL objects with `id`, text `prompt`, "
                 "and paired `pos_answers`/`neg_answers` lists.")
        self.ids = [x["id"] for x in records]

        pos = [[x["prompt"] + c + tokenizer.eos_token
                for c in x["pos_answers"]] for x in records]
        neg = [[x["prompt"] + c + tokenizer.eos_token
                for c in x["neg_answers"]] for x in records]
        for a, b in zip(pos, neg):
            if len(a) != len(b):
                raise RuntimeError(
                    "pos_answers and neg_answers must be paired.")
            if not a:
                raise RuntimeError(
                    "pos_answers and neg_answers must be non-empty.")
        group_sizes = [len(x) for x in pos]

        self.prompt_lengths = [
            int(l) for l in tokenizer(
                [x["prompt"] for x in records], max_length=max_length,
                truncation=True, padding=False, return_length=True)["length"]]

        def _group(flat_tokens):
            grouped, off = [], 0
            for g in group_sizes:
                grouped.append(flat_tokens["input_ids"][off:off + g])
                off += g
            return grouped

        tok_kw = dict(max_length=max_length, truncation=True, padding=False,
                      return_length=True)
        self.pos_tokens = _group(tokenizer(
            list(itertools.chain.from_iterable(pos)), **tok_kw))
        self.neg_tokens = _group(tokenizer(
            list(itertools.chain.from_iterable(neg)), **tok_kw))
        logger.info("Loaded %d reward-modeling prompts.", len(self.ids))

    @property
    def util(self):
        return self._util

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        n_pairs = len(self.pos_tokens[idx])
        group_size = min(self.max_pairs_per_prompt, n_pairs)
        chosen = self.rng.choice(n_pairs, group_size, replace=False)

        packed, input_lens = [], []
        for i in chosen:
            packed += list(self.pos_tokens[idx][i])
            packed += list(self.neg_tokens[idx][i])
            input_lens += [len(self.pos_tokens[idx][i]),
                           len(self.neg_tokens[idx][i])]

        return data_api.SequenceSample(
            keys=["packed_input_ids", "prompt_lens"],
            data=dict(
                packed_input_ids=np.asarray(packed, dtype=np.int32),
                prompt_lens=np.asarray([self.prompt_lengths[idx]],
                                       dtype=np.int32),
            ),
            dtypes=dict(packed_input_ids=np.int32, prompt_lens=np.int32),
            trailing_shapes=dict(packed_input_ids=(), prompt_lens=()),
            ids=[self.ids[idx]],
            seqlens=dict(packed_input_ids=[input_lens], prompt_lens=[[1]]),
        )


data_api.register_dataset("rw_pair", RewardModelingPairedDataset)
