"""Prompt + answer dataset for SFT.

JSONL records with "id", "prompt" and "answer". Each item yields
``packed_input_ids`` (prompt + answer + EOS, tokenized together) and a
boolean ``prompt_mask`` (True over the prompt's tokens, which the SFT
loss leaves out).
"""

from typing import Callable, Dict, List, Optional

import numpy as np

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.base import logging

logger = logging.getLogger("PromptAnswerDataset")


class PromptAnswerDataset:

    def __init__(self, util: data_api.DatasetUtility, max_length: int,
                 dataset_path: Optional[str] = None,
                 dataset_builder: Optional[Callable[[], List[Dict]]] = None,
                 pad_to_max_length: bool = False):
        self._util = util
        tokenizer = util.tokenizer

        records = data_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder)
        data_api.require_record_fields(
            records, ("prompt", "answer"), "PromptAnswerDataset",
            hint=" Expected JSONL objects with `id`, text `prompt` "
                 "and text `answer`.")
        self.ids = [x["id"] for x in records]
        seqs = [x["prompt"] + x["answer"] + tokenizer.eos_token
                for x in records]
        self.tokens = tokenizer(
            seqs, truncation=True, max_length=max_length, return_length=True,
            return_attention_mask=False,
            padding="max_length" if pad_to_max_length else False)
        prompt_tokens = tokenizer(
            [x["prompt"] for x in records], truncation=True,
            max_length=max_length, return_length=True,
            return_attention_mask=False, padding=False)

        self.prompt_masks = []
        for plen, slen in zip(prompt_tokens["length"], self.tokens["length"]):
            plen, slen = int(plen), int(slen)
            if slen < plen:
                raise ValueError(f"a sequence of {slen} tokens is shorter "
                                 f"than its prompt ({plen})")
            self.prompt_masks.append(
                np.array([True] * plen + [False] * (slen - plen)))
        logger.info("Loaded %d prompt-answer sequences.", len(self.ids))

    @property
    def util(self):
        return self._util

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        ids = np.asarray(self.tokens["input_ids"][idx], dtype=np.int32)
        return data_api.SequenceSample.from_default(
            ids=[self.ids[idx]],
            seqlens=[len(ids)],
            data=dict(packed_input_ids=ids,
                      prompt_mask=self.prompt_masks[idx]),
        )


data_api.register_dataset("prompt_answer", PromptAnswerDataset)
