"""Autoregressive batch generation with a KV cache and sampling.

Prefill, then a Python loop of one-token decode steps: temperature /
top-k / top-p or greedy, min/max new tokens with EOS suppression,
EOS+pad handling, per-step logprobs of the sampled tokens, and the
logits mask PPO replays. When EOS can end every stream early, the loop
checks after each step whether any stream is unfinished and stops when
none is.

Over the members of a ``dNtM`` layout (``models/sharding.MemberParams``)
the loop is the same: prefill and every decode step run on each member
with its own cache (``models/transformer.py``), the logits of the whole
batch are gathered on the first member's device, and sampling draws
from the one generator in the order of the one-device loop, so greedy
and sampled tokens are those of a one-device engine with the same
weights, up to the order of the members' sums.
"""

import dataclasses
import time
from typing import Dict, Optional

import torch

from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.models.sharding import MemberParams
from realhf_tpu_torch.ops.sampling import (
    NEG_INF,
    GenerationHyperparameters,
    categorical,
    top_k_top_p_logits,
)


@dataclasses.dataclass
class GenerationOutput:
    """Results in [B, max_new_tokens] layout; ``lengths`` counts the
    generated tokens per stream (including the EOS if emitted)."""
    tokens: torch.Tensor                  # int32 [B, T], pad beyond lengths
    logprobs: torch.Tensor                # fp32 [B, T] of the sampled tokens
    logits_mask: Optional[torch.Tensor]   # bool [B, T, V], True = allowed
    lengths: torch.Tensor                 # int32 [B]
    no_eos_mask: torch.Tensor             # bool [B]: never emitted EOS
    #: decode steps run, tokens generated, and host-clock seconds of
    #: prefill and of the decode loop (each up to a device synchronisation)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_host(self) -> "GenerationOutput":
        """Every tensor field as a host numpy array."""
        conv = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
        for k, v in conv.items():
            if isinstance(v, torch.Tensor):
                conv[k] = v.cpu().numpy()
        return GenerationOutput(**conv)


def _sync(params, device: torch.device):
    devices = (set(params.devices) if isinstance(params, MemberParams)
               else {device})
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


@torch.inference_mode()
def generate(cfg: TransformerConfig, params, prompt_ids: torch.Tensor,
             prompt_seg: torch.Tensor, prompt_pos: torch.Tensor,
             generator: Optional[torch.Generator],
             gconfig: GenerationHyperparameters, *,
             eos_token_id: Optional[int], pad_token_id: int
             ) -> GenerationOutput:
    """``prompt_*`` are [B, Lp] left-padded (seg 1 over content).
    ``generator`` (on the prompts' device) drives sampling; greedy
    decoding ignores it. With an EOS token that may end every stream
    before ``max_new_tokens``, the loop stops once none is unfinished
    (one host synchronisation per step)."""
    device = prompt_ids.device
    b, lp = prompt_ids.shape
    t_max = gconfig.max_new_tokens
    prompt_lens = (prompt_seg != 0).sum(-1).to(torch.int32)

    t0 = time.monotonic()
    hidden, cache = T.prefill(cfg, params, prompt_ids, prompt_seg,
                              prompt_pos, total_len=lp + t_max)
    # left padding: last column = last token
    last_hidden = (hidden.map(lambda h: h[:, -1])
                   if isinstance(params, MemberParams) else hidden[:, -1])
    _sync(params, device)
    t_prefill = time.monotonic() - t0

    vocab = torch.arange(cfg.vocab_size, device=device)[None, :]
    want_mask = not gconfig.force_no_logits_mask
    tokens_buf = torch.full((b, t_max), pad_token_id, dtype=torch.int32,
                            device=device)
    logp_buf = torch.zeros((b, t_max), dtype=torch.float32, device=device)
    mask_buf = (torch.zeros((b, t_max, cfg.vocab_size), dtype=torch.bool,
                            device=device) if want_mask else None)
    unfinished = torch.ones((b,), dtype=torch.bool, device=device)
    emitted = torch.zeros((b,), dtype=torch.int32, device=device)
    early_exit = (eos_token_id is not None
                  and gconfig.min_new_tokens < t_max)

    t0 = time.monotonic()
    steps = 0
    for step in range(t_max):
        logits = T.lm_logits(cfg, params, last_hidden)
        eos_suppress = None
        if (eos_token_id is not None and step < gconfig.min_new_tokens):
            eos_suppress = vocab == eos_token_id
            logits = torch.where(eos_suppress, NEG_INF, logits)
        if gconfig.greedy:
            warped = logits
            tok = warped.argmax(-1).to(torch.int32)
        else:
            warped = top_k_top_p_logits(logits / gconfig.temperature,
                                        gconfig.top_k, gconfig.top_p)
            if eos_suppress is not None:
                # re-pin after temperature scaling so the mask below
                # classifies the suppressed EOS as disallowed
                warped = torch.where(eos_suppress, NEG_INF, warped)
            tok = categorical(warped, generator).to(torch.int32)
        logp = torch.log_softmax(warped, -1)
        logprob = logp.gather(-1, tok[:, None].long())[:, 0]
        emitted += unfinished.to(torch.int32)
        tok = torch.where(unfinished, tok, pad_token_id)
        if eos_token_id is not None:
            unfinished = unfinished & (tok != eos_token_id)
        tokens_buf[:, step] = tok
        logp_buf[:, step] = logprob
        if want_mask:
            mask_buf[:, step] = warped > NEG_INF / 2
        pos = prompt_lens + step
        last_hidden, cache = T.decode_step(cfg, params, cache, tok, pos,
                                           uniform_slot=True)
        steps += 1
        if early_exit and not bool(unfinished.any()):
            break
    _sync(params, device)
    t_decode = time.monotonic() - t0
    return GenerationOutput(
        tokens=tokens_buf, logprobs=logp_buf, logits_mask=mask_buf,
        lengths=emitted, no_eos_mask=unfinished,
        stats=dict(prefill_secs=t_prefill, decode_secs=t_decode,
                   decode_steps=steps,
                   generated_tokens=int(emitted.sum())))

