"""Synthetic prompt dataset for profile/mock mode.

Random token prompts with a configurable length distribution, drawn
from the experiment seed: no files or tokenizer involved.
"""

from typing import Optional

import numpy as np

from realhf_tpu_torch.api import data as data_api


class RandomPromptDataset:

    def __init__(self, util: data_api.DatasetUtility, n_prompts: int = 256,
                 prompt_len_min: int = 32, prompt_len_max: int = 256,
                 vocab_size: int = 32000, max_length: Optional[int] = None):
        self._util = util
        rng = np.random.default_rng(util.seed + util.dp_rank)
        hi = min(prompt_len_max, max_length or prompt_len_max)
        lo = min(prompt_len_min, hi)
        self.lengths = rng.integers(lo, hi + 1,
                                    size=n_prompts).astype(int)
        # ids >= 2: 0/1 are conventionally pad/eos
        self.prompts = [rng.integers(2, vocab_size, size=l)
                        .astype(np.int32) for l in self.lengths]

    @property
    def util(self):
        return self._util

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return data_api.SequenceSample.from_default(
            ids=[idx],
            seqlens=[int(self.lengths[idx])],
            data=dict(packed_prompts=self.prompts[idx]),
        )


data_api.register_dataset("random_prompt", RandomPromptDataset)
