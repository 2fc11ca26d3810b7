"""Batch generation interface: generate and optionally append the
results to a JSONL file (locked, append-only)."""

import dataclasses
import fcntl
import json
import os
from typing import Optional

import numpy as np

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.base import logging, seeding
from realhf_tpu_torch.base.datapack import flat2d
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters

logger = logging.getLogger("GenerationInterface")


def sampling_generator(calls: int, device):
    """The sampling stream of the ``calls``-th generate call: a
    generator on ``device`` seeded from (experiment seed, call count),
    so each call draws fresh, reproducible randomness."""
    try:
        seed = seeding.get_seed()
    except RuntimeError:
        seed = 0
    return seeding.generator(
        seeding.derive_seed_from(seed, "generate", calls), device)


@dataclasses.dataclass
class GenerationInterface(model_api.ModelInterface):
    output_file: Optional[str] = None
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters)
    use_inflight_batching: bool = False

    def __post_init__(self):
        if isinstance(self.gconfig, dict):
            self.gconfig = GenerationHyperparameters(**self.gconfig)
        if self.use_inflight_batching:
            raise NotImplementedError(
                "inflight (continuous) batching is deferred to the serving "
                "slice of the port (engine/inflight.py).")
        self._calls = 0

    def generate(self, model: model_api.Model, input_: SequenceSample,
                 n_mbs: Optional[int] = None) -> SequenceSample:
        tok = model.tokenizer
        prompt_lens = flat2d(input_.seqlens["packed_prompts"])
        flat = input_.data["packed_prompts"]
        prompts, off = [], 0
        for l in prompt_lens:
            prompts.append(np.asarray(flat[off:off + l]))
            off += l
        self._calls += 1
        gen = sampling_generator(self._calls, model.engine.device)

        ids, seg, pos = packing.left_padded_prompts(
            prompts, pad_id=tok.pad_token_id)
        out = model.engine.generate(
            ids, seg, pos, gen, self.gconfig,
            eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id).to_host()
        gen_tokens = np.asarray(out.tokens)
        lengths = np.asarray(out.lengths)

        if self.output_file is not None:
            path = self.output_file
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            records = []
            for i, p in enumerate(prompts):
                g = int(lengths[i])
                records.append(dict(
                    id=str(input_.ids[i]),
                    prompt=tok.decode(p.tolist()),
                    answer=tok.decode(gen_tokens[i, :g].tolist(),
                                      skip_special_tokens=True)))
            with open(path, "a") as f:
                fcntl.flock(f, fcntl.LOCK_EX)
                for r in records:
                    f.write(json.dumps(r, ensure_ascii=False) + "\n")
                fcntl.flock(f, fcntl.LOCK_UN)

        seqlens, in_ids = [], []
        for i, p in enumerate(prompts):
            g = int(lengths[i])
            seqlens.append(len(p) + g)
            in_ids.append(np.concatenate([p, gen_tokens[i, :g]]))
        return SequenceSample.from_default(
            ids=input_.ids, seqlens=seqlens,
            data=dict(packed_input_ids=np.concatenate(in_ids)
                      .astype(np.int32)))


model_api.register_interface("generation", GenerationInterface)
