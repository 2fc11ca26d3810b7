"""Agentic task datasets: checker-task prompts and tool-game seeds.

Token-level synthetic datasets for the agentic envs
(``realhf_tpu_torch/agentic/env.py``). Both are deterministic in
``(seed, dp_rank)`` and need no tokenizer or files. Records may also
come from a JSONL file whose objects carry ``prompt_tokens`` (a token-id
list); a malformed record fails the load with the record named."""

import json
from typing import List, Optional

import numpy as np

from realhf_tpu_torch.agentic.env import PAYLOAD_BASE
from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.base import logging

logger = logging.getLogger("AgenticDataset")


def _load_token_records(util: data_api.DatasetUtility, path: str,
                        loader: str) -> List[np.ndarray]:
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    data_api.require_record_fields(
        records, ("prompt_tokens",), loader,
        hint=" Records must carry token-id lists, not text: agentic "
             "envs speak token ids.")
    for rec in records:
        toks = rec["prompt_tokens"]
        if not isinstance(toks, list) or not toks or not all(
                isinstance(t, int) and t >= 0 for t in toks):
            raise ValueError(
                f"{loader}: record {rec.get('id', '?')!r}: "
                f"prompt_tokens must be a non-empty list of "
                f"non-negative ints, got {toks!r}.")
    rng = np.random.default_rng(util.seed)
    idx = np.arange(len(records))
    rng.shuffle(idx)
    shard = np.array_split(idx, util.world_size)[util.dp_rank]
    return [np.asarray(records[i]["prompt_tokens"], np.int32)
            for i in shard]


class _AgenticPromptBase:
    """Map-style dataset of ``packed_prompts`` samples over raw token
    prompts (the shape of RandomPromptDataset's)."""

    def __init__(self, util: data_api.DatasetUtility,
                 prompts: List[np.ndarray]):
        self._util = util
        self.prompts = prompts

    @property
    def util(self):
        return self._util

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return data_api.SequenceSample.from_default(
            ids=[idx],
            seqlens=[len(self.prompts[idx])],
            data=dict(packed_prompts=self.prompts[idx]),
        )


class CheckerTaskDataset(_AgenticPromptBase):
    """Prompts for the verifiable-reward ``checker_task`` env: random
    payload tokens whose last one/two tokens define the checked answer
    (CheckerEnv derives the target from the prompt, so prompt == full
    task specification)."""

    def __init__(self, util: data_api.DatasetUtility,
                 n_prompts: int = 128, prompt_len_min: int = 4,
                 prompt_len_max: int = 8, vocab_size: int = 97,
                 dataset_path: Optional[str] = None):
        if dataset_path:
            prompts = _load_token_records(util, dataset_path,
                                          "CheckerTaskDataset")
        else:
            rng = np.random.default_rng(util.seed * 7919 + util.dp_rank)
            lo = min(prompt_len_min, prompt_len_max)
            lens = rng.integers(lo, prompt_len_max + 1, size=n_prompts)
            prompts = [rng.integers(PAYLOAD_BASE, vocab_size, size=l)
                       .astype(np.int32) for l in lens]
        super().__init__(util, prompts)
        logger.info("Loaded %d checker-task prompts.", len(prompts))


class ToolGameDataset(_AgenticPromptBase):
    """Seeds for the multi-turn ``tool_game`` env: short random
    prompts whose tokens seed the hidden target sequence (ToolGameEnv
    derives targets from prompt + seed, so distinct prompts are
    distinct games)."""

    def __init__(self, util: data_api.DatasetUtility,
                 n_prompts: int = 128, prompt_len: int = 4,
                 vocab_size: int = 97,
                 dataset_path: Optional[str] = None):
        if dataset_path:
            prompts = _load_token_records(util, dataset_path,
                                          "ToolGameDataset")
        else:
            rng = np.random.default_rng(util.seed * 6271 + util.dp_rank)
            prompts = [rng.integers(PAYLOAD_BASE, vocab_size,
                                    size=prompt_len).astype(np.int32)
                       for _ in range(n_prompts)]
        super().__init__(util, prompts)
        logger.info("Loaded %d tool-game seeds.", len(prompts))


data_api.register_dataset("checker_task", CheckerTaskDataset)
data_api.register_dataset("tool_game", ToolGameDataset)
