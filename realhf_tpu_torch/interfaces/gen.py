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


def sampling_generator(calls: int, device, stream: str = "generate"):
    """The sampling stream of the ``calls``-th generate call of a
    ``stream``: a generator on ``device`` seeded from (experiment seed,
    stream, call count), so each call draws fresh, reproducible
    randomness and streams of different callers never coincide."""
    try:
        seed = seeding.get_seed()
    except RuntimeError:
        seed = 0
    return seeding.generator(
        seeding.derive_seed_from(seed, stream, calls), device)


@dataclasses.dataclass
class GenerationInterface(model_api.ModelInterface):
    output_file: Optional[str] = None
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters)
    # continuous batching: slots refill from the prompt queue as
    # sequences finish (engine/inflight.py); needs force_no_logits_mask
    use_inflight_batching: bool = False
    inflight_slots: int = 0  # 0 = batch size

    def __post_init__(self):
        if isinstance(self.gconfig, dict):
            self.gconfig = GenerationHyperparameters(**self.gconfig)
        self._calls = 0
        self._inflight = None
        self._inflight_layout = None

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

        if self.use_inflight_batching:
            gen_tokens, lengths = self._generate_inflight(model, prompts, gen)
        else:
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

    def _generate_inflight(self, model: model_api.Model, prompts, gen):
        """All prompts through the continuous-batching generator ->
        (tokens [B, max generated] padded, lengths [B]). It runs on the
        engine's decode view (``Engine.decode_engine``) at pipeline,
        context-parallel and ``g != t`` layouts, as batch generation
        does; a change of the view's layout rebuilds it."""
        from realhf_tpu_torch.engine.inflight import (
            InflightBatchingGenerator,
            _bucket,
        )
        from realhf_tpu_torch.models.sharding import MemberParams
        tok = model.tokenizer
        eng = model.engine.decode_engine()
        mp = eng.params
        layout = ((mp.d, mp.t, tuple(mp.devices))
                  if isinstance(mp, MemberParams) else None)
        # bucket the cache so slowly growing prompt lengths reuse the
        # generator instead of rebuilding it every batch
        need = _bucket(max(64, max(len(p) for p in prompts)))
        n_slots = self.inflight_slots or len(prompts)
        if (self._inflight is None
                or self._inflight.cache_len
                - self.gconfig.max_new_tokens < need
                or self._inflight.n_slots != n_slots
                or self._inflight_layout != layout):
            # a later batch may carry longer prompts, or (with
            # inflight_slots=0, "the batch size") another prompt count
            self._inflight = InflightBatchingGenerator(
                model.config, eng.params, self.gconfig, n_slots=n_slots,
                max_prompt_len=need, eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id, device=eng.device)
            self._inflight_layout = layout
        self._inflight.swap_params(eng.params)  # fresh weights
        finished = self._inflight.generate_all(prompts, gen)
        # hold no reference to the weights (the view's) between calls
        self._inflight.params = None
        lengths = np.asarray([len(f.tokens) for f in finished])
        maxg = max(1, int(lengths.max()))
        gen_tokens = np.full((len(prompts), maxg), tok.pad_token_id,
                             np.int32)
        for i, f in enumerate(finished):
            gen_tokens[i, :len(f.tokens)] = f.tokens
        return gen_tokens, lengths


model_api.register_interface("generation", GenerationInterface)
