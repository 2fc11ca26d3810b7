"""Prompt-only dataset for PPO / generation.

JSONL records with a unique "id" and a "prompt"; each item yields a
SequenceSample with key ``packed_prompts``.
"""

import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.base import logging

logger = logging.getLogger("PromptDataset")


class PromptDataset:

    def __init__(self, util: data_api.DatasetUtility,
                 max_length: Optional[int] = None,
                 dataset_path: Optional[str] = None,
                 dataset_builder: Optional[Callable[[], List[Dict]]] = None,
                 pad_to_max_length: bool = False):
        self._util = util
        self.max_length = max_length

        records = data_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder)
        data_api.require_record_fields(
            records, ("prompt",), "PromptDataset",
            hint=" Expected JSONL objects with a unique `id` and a "
                 "text `prompt`.")
        self.ids = [x["id"] for x in records]
        util.tokenizer.padding_side = "left"
        enc = util.tokenizer(
            [x["prompt"] for x in records],
            truncation=True,
            max_length=max_length,
            padding="max_length" if pad_to_max_length else False,
            return_length=True,
            return_attention_mask=False)
        self.prompt_lengths = [int(l) for l in enc["length"]]
        self.prompts = enc["input_ids"]
        logger.info("Loaded %d prompts.", len(self.prompts))

    @property
    def util(self):
        return self._util

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return data_api.SequenceSample.from_default(
            ids=[self.ids[idx]],
            seqlens=[self.prompt_lengths[idx]],
            data=dict(packed_prompts=np.asarray(self.prompts[idx], dtype=np.int32)),
            metadata=dict(random_id=[uuid.uuid4()]),
        )


data_api.register_dataset("prompt", PromptDataset)
