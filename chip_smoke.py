#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``realhf_tpu_torch``) on the GPU.

    python3 chip_smoke.py [--out results.json]

Phases, all run every time (each prints one JSON line; any failure
exits non-zero):

1. device  -- the card's name and power limit, PyTorch and CUDA versions.
2. build   -- compiles every CUDA kernel of the port from this checkout.
3. kernels -- each kernel against its plain PyTorch version on the card,
   in bf16, at the main paths' shapes and at GQA / hd 64 / ragged /
   empty-row / non-causal shapes: max abs error, and the largest error
   of an output row over that row's RMS beside its limit. Planted
   faults must exceed the limits: a decode call with the newest slot of
   each stream dropped (K4), a decode merge with one warp's partial left
   out, the backward with delta taken as 0 (K3), the
   forward (K1) and the backward (K2 and K3) held against the plain
   version on segment boundaries shifted by one token. K1's and K2/K3's
   cases include the edges of their tile skipping: ids that recur out of
   order, one segment over many tiles then short ones, rows whose first q
   tiles are all padding; each prints the (query, key) pairs the kernel
   walks (``visited_key_tiles``; K3 ``visited_q_tiles``) beside the pairs
   the mask allows. Two launches of K2 and K3 must give the same bits.
   K4/K5 cases (gen and GQA shapes, B 1, a sliding window, a stream
   kept only in its last tile, interior holes, a stacked-cache layer)
   run twice (the same bits); each prints the slots of the tiles walked
   beside the slots kept. Timed K4/K5 cases rotate over >= 200 MB of
   layer caches and queue the launches ahead of the device
   (``queued_ms``), for the kernel and the library call alike.
   Then each kernel's time, the plain version's time, one PyTorch
   library call's time (``scaled_dot_product_attention`` with the same
   boolean mask, forward or backward, a yardstick only) and the least
   time the card could take (bound).
   K6 (``ring_attention``) against ``ring_attention_plain`` (fp32 on the
   card) over members on ``member_devices(n)`` (cuda:0..3 on a machine of
   four cards, else all on cuda:0): at the ctx-7b-c4 stream (n 4, lc
   8192; timed; planted faults: member 1 skipping round 1, local in place
   of global offsets), GQA 8/2 at hd 64 with ragged tiles, non-causal, a
   sliding window, unidirectional, n 2, n 8, one member and ids that
   recur out of order across shards; each prints the pairs the kernel
   walks over the whole ring (``visited_key_tiles`` on global offsets)
   beside the pairs the mask allows. The library
   yardstick is SDPA over the gathered stream with the same boolean mask.
   Then the push kernel alone at the ctx path's halves (bit-exact).
4. main    -- the ``gen`` experiment through the port's
   ``GenerationConfig.build()`` and ``InlineRunner`` at full LLaMA-7B
   width and depth (random weights from the seed, integer tokenizer,
   8 prompts of 100-512 words per batch, 128 new tokens): two greedy
   steps, then one sampled step (top-k 50, top-p 0.9). Checks that the
   flash-forward kernel ran once per layer per step and flash-decode once
   per layer per decode step, and that the outputs are in range.
5. deep    -- the same experiment on a 49-layer model of 7B width, the
   depth at which decoding reads the stacked KV cache through the
   decode kernel's stacked-cache entry.
6. profile -- a torch.profiler trace of one 7B generate call (8 prompts,
   16 new tokens): kernel time and device busy share of prefill and of
   a decode step, and the kernels by time. Reports, never fails.
7. sft     -- the ``sft`` experiment through ``SFTConfig.build()`` and
   ``InlineRunner`` at LLaMA-7B width, 8 layers, bf16, gradient
   checkpointing on: 16 prompt-answer records (100-400 words each side)
   in 2 microbatches of one ~4 k-token stream, 3 epochs, lr 1e-5 (at
   1e-4 the loss rises on step 3; phase sft_lr), eval on the same file
   after the third. Checks that every step's loss is
   finite and below the one before, that step 1 gave every layer of
   every parameter leaf a finite, non-zero gradient, and the launch
   counts: K2 = K3 = 8 layers x 2 microbatches x 3 steps, K1 twice that
   (forward and checkpoint recompute) plus 8 per eval batch.
8. sft_profile -- a torch.profiler trace of one more sft step:
   device time of K1/K2/K3, GEMMs and the rest, and the optimizer step's time.
   Reports, never fails.
   sft_lr -- the same cell at lr 1e-4: 3 steps of the port (bf16, the
   kernels) and of a plain reference on the card (fp32 weights, compute
   and optimizer, attention through ``packed_attention_plain``) from the
   same initial weights and batch. Each step's loss must agree; the lr
   1e-5 trajectory of phase sft must not.
9. parity  -- 7B width, 2 layers, 2 prompts: prefill and 8 greedy decode
   steps through the port on the card (kernels, bf16) and on the CPU
   (plain versions, fp32) from the same weights; logits must agree. The
   LM head on bf16 hidden states must return fp32 sums, not bf16-rounded
   ones.
10. train_parity -- three SFT steps at lr 1e-4 on the card (bf16,
   kernels) and on the CPU (fp32, plain versions) from the same bf16
   weights and two microbatches (2 layers, hidden 1024, 8 heads of 128,
   FFN 2816, vocab 32000, ~510 tokens): step 1's loss, grad norm and the
   cosine similarity (in fp64) of every layer's slice of every gradient
   leaf, and the loss of steps 2-3, within limits; the same check with
   layer 1's wq/wk/wv gradients zeroed must fail them.

11. ppo    -- the ``ppo`` experiment through ``PPOConfig.build()`` and
   ``InlineRunner`` at LLaMA-7B width, 4 layers for each of actor,
   critic, ref and reward, bf16, gradient checkpointing on: 2 steps of
   16 prompts (100-512 words), up to 128 sampled new tokens (top-p 0.9,
   top-k 200, temperature 1, the logits mask kept), 4 minibatches per
   train MFC, lr 1e-5. Checks that all six MFCs ran on both steps, every
   stat is finite, tokens are in range and inside their logits mask,
   each step's first-minibatch importance weight and approximate KL are
   within their limits (the packed forward reproduces the decode path's
   log-probs), the versions advanced, and the launch counts, derived
   from the configuration and the decode steps taken: per step K1 = 4L
   + 2 x N x 2L, K2 = K3 = 2 x N x L, K4 = L x decode steps (L layers, N
   minibatches). Seconds per MFC (the script times ``host.execute``
   between device synchronisations), per step, tokens per second and
   the allocator's peak are reported. Then one step of a second runner
   with ``auto_offload``: ref and reward report ``offloaded``, the
   allocated device memory fell by their bytes, and their bits come back.
12. ppo_profile -- one more step, each MFC under torch.profiler: device
   time by MFC and by kernel class (K1-K4, GEMMs, the rest), the busy
   share, the optimizer steps' time. Reports, never fails.
   kernels (ppo shapes) -- K1-K4 against their plain versions, with the
   limits and planted faults of phase 3, at the segment matrices the
   ppo path's packer made: the prefill of 16 left-padded prompts, the
   ~6 k-token stream of 16 sequences of the three inference MFCs, the
   longest 4-sequence minibatch stream (forward and backward), and
   decode at 16 streams.
13. ppo_parity -- 2 layers, hidden 1024: one greedy rollout on the card,
   then the same batch through rew_inf, ref_inf and critic_inf on the
   card (bf16, kernels) and on the CPU (fp32, plain versions) from the
   same weights: rewards, reference log-probs and values within limits;
   then actor_train and critic_train on the card (bf16, kernels,
   optimizer state offloaded between train calls) against a plain fp32
   reference of the same step on the card: each first-minibatch loss,
   grad norm and importance weight within limits (the card's bf16 step
   with the plain attention, and the CPU's fp32 one, are reported
   beside). The generation log-probs shifted by one token must read an
   approximate KL over 10x its limit, the old values shifted by one
   token a value loss over 10x its limit.
14. ctx -- ``Engine.forward_logprobs`` of a 32-layer LLaMA-7B (random bf16
   weights) over one packed stream of 32768 tokens (documents of 12288,
   7168, 6144, 4096 and 2816 tokens, then 256 of padding) on a c4 layout
   over ``member_devices(4)``, then on c1 with the same weight tensors
   (K1 over the whole stream): seconds, tokens/s, peak memory, exact
   launch counts (c4: K6 rounds 32 x 4 x 4, pushes 32 x 3 x 4, K1 none),
   and c4 against c1 on the log-probs of the valid positions.
15. ppo_ctx -- the ppo cell with ref and reward at
   ``context_parallel_size=4``: one step; ref_inf and rew_inf each launch
   K6 exactly (layers x 4 x 4 rounds) and K1 never; the step's batch then
   goes through ref_inf and rew_inf of a c1 host from the same seed:
   reference log-probs and rewards within limits.

16-21. The other algorithms at LLaMA-7B width, 4 layers a role, bf16,
   gradient checkpointing on, random weights and data from the seed;
   each checks its exact K1-K4 launch counts (L layers, N minibatches,
   the decode steps taken), finite stats, and one check of its own with
   a planted fault that must fail it, and reports step and per-MFC
   seconds and the peak beside the card:
   rw -- ``RWConfig``, 2 steps of 8 prompts x 2 (pos, neg) pairs
   (answers of 50-200 words); per step K1 = 2L, K2 = K3 = L. Then one
   ``paired_rw`` step card (bf16, kernels) vs CPU (fp32, plain) at
   ``train_parity``'s size: loss and grad norm; every pair swapped
   must miss the loss limit.
   dpo -- ``DPOConfig`` on the same data, the actor's weights copied into
   the ref: step 1's loss ln 2, its KL and scores 0; per step K1 = 3L,
   K2 = K3 = L. The ref's pos and neg sums swapped must miss by 10x.
   grpo -- ``GRPOConfig``, 4 prompts x group 4 = 16 decode streams, up
   to 128 new tokens at top-p 1, top-k 0, 4 minibatches, ref = actor:
   each id holds 4 sequences, first-minibatch importance weight within
   PPO's limit, step 1's |grpo_kl| within its own; per step K1 = 3L +
   2NL, K2 = K3 = NL, K4 = L x decode steps. Old log-probs shifted by
   one token must miss by 10x.
   reinforce -- ``ReinforceInterface`` on ``build_model``'s actor,
   reward and ref, 2 rounds of 8 prompts: the greedy halves bit-equal
   to a greedy ``PPOActorInterface.generate`` (the sampled halves not),
   the loss mask exactly the sampled halves' tokens; per round K1 = 4L +
   2NL, K2 = K3 = NL, K4 = L x (sampled + greedy decode steps).
   agentic -- ``AgenticPPOConfig`` on ``tool_game`` (3 turns, 32 new
   tokens a turn, top-p 1, top-k 0) with turn-level credit, 2 steps of
   16 episodes: none dropped, turn rewards summing to each episode's,
   first-minibatch importance weight within PPO's limit (shifted
   log-probs must miss by 10x); per step K1 = L x generate calls + 2L +
   4NL, K2 = K3 = 2NL, K4 = L x decode steps.
   profile_exp -- ``ProfileConfig(model_size="7b")`` cut to 4 layers, 16
   random prompts of 100-512 tokens, 128 new tokens, 1 step: the six
   MFCs with PPO's launch formula, per-MFC seconds.

22. ckpt_gen -- checkpoint IO at the gen cell's full width and depth
   (32 layers, bf16, ~13.5 GB): the model saved with the streamed save
   (``models/hf/registry.py``) under ``_ckpt_scratch/`` beside this
   script (the free disk checked first), then loaded into a new gen
   runner (``model.path``; ``build_model`` streams one layer at a time
   onto the card): every leaf ``torch.equal`` to the saved model's and
   to the registry's eager load of the same files
   (``hf.load_hf_checkpoint``, host numpy), a greedy batch of 8 prompts
   x 32 new tokens equal to the original model's tokens, exact K1/K4
   counts. Planted fault: a loader that skips q_proj's transpose (square
   at this width) must fail both checks. Reports bytes written, save
   and load seconds (GB/s), the host peak growth of the runner's load and
   of the eager read (VmHWM reset through ``/proc/self/clear_refs``,
   else sampled VmRSS) and the load's device peak growth.
23. ckpt_resume -- the sft cell at 7B width, 4 layers, lr 1e-5, gradient
   checkpointing, 3 steps of 16 records in one epoch: run A takes 3
   steps; run B takes 2 with ``save_freq_steps=1`` and
   ``recover_mode="auto"`` (weights ~2.1 GB, optimizer state ~12.8 GB
   per save); run C, a new ``InlineRunner(recover_mode="resume")``, takes
   step 3: its batch ids, loss, grad norm and updated weights must equal
   A's step 3 (bit for bit), with exact K1/K2/K3 counts. Planted fault:
   C with the optimizer state left fresh must move a weight by at least
   ten times the limit (1% of the step's largest update). Reports the
   weights' and the optimizer state's save seconds, the resume's setup
   seconds and host peak growth.

The phases before 22 run with the saves of their trained roles switched
off (``without_saves``: ``enable_save=False`` on every train MFC's
interface), as they ran before the port could save.

Then a ``{"kernels": [...]}`` line (launches summed over the gen, deep,
sft, ppo, ctx, ppo_ctx, algorithm and checkpoint paths, each counted
from 0), the
``nvidia-smi`` name/power line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
NEG_INF = -2.0 ** 30
# Error limits, each about 3x the largest reading of a sound kernel over
# the cases of phase 3 (PERF.md, Findings): output rows as row_rel_err,
# the softmax statistics absolute (lse, m) or relative (l).
LIMITS = dict(flash_fwd_row_rel=0.1, flash_fwd_lse=6e-6,
              flash_decode_row_rel=0.08, flash_decode_m=5e-6,
              flash_decode_l_rel=5e-6, flash_bwd_dq_row_rel=0.07,
              flash_bwd_dk_row_rel=0.07, flash_bwd_dv_row_rel=0.07,
              ring_row_rel=0.06)

RESULTS = {}


def emit(phase, **kw):
    rec = dict(phase=phase, **kw)
    RESULTS[phase] = rec
    print(json.dumps(rec), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref, rows, floor_frac=0.0) -> float:
    """Largest |out - ref| of an output row over the RMS of that row of
    ``ref``, over the rows where ``rows`` (out's shape less its last
    dim) is true. Rows averaging many values are small, so an absolute
    limit would let a dropped key through where they are. With
    ``floor_frac``, a row's RMS counts as at least that share of the RMS
    over all such rows: a gradient row whose exact value is 0 (the first
    token of a segment attends to itself alone, so its ds = p (dp -
    delta) cancels) holds rounding noise on both sides."""
    d = (out.float() - ref.float()).abs().amax(-1)
    sq = ref.float().pow(2).mean(-1)
    floor = floor_frac * float(sq[rows].mean().sqrt())
    rms = sq.sqrt().clamp_min(max(floor, 1e-6))
    return float((d / rms)[rows].max())


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------
def left_padded_seg(lengths, L, device):
    import torch
    seg = torch.zeros((len(lengths), L), dtype=torch.int32, device=device)
    for i, n in enumerate(lengths):
        seg[i, L - n:] = 1
    return seg


def packed_seg(rng, b, L, n_segs, pad_rows, device):
    """Multi-segment packing, a padded tail on every row, and all-pad
    rows at ``pad_rows``."""
    import numpy as np
    import torch
    seg = np.zeros((b, L), np.int32)
    for bi in range(b):
        if bi in pad_rows:
            continue
        cuts = np.sort(rng.choice(np.arange(1, L - 1), n_segs - 1,
                                  replace=False))
        cuts = np.concatenate([[0], cuts, [L]])
        for s in range(n_segs):
            seg[bi, cuts[s]:cuts[s + 1]] = s + 1
        seg[bi, L - int(rng.integers(1, L // 8)):] = 0
    return torch.from_numpy(seg).to(device)


def recurring_seg(rng, b, L, device):
    """Pieces of 1-150 tokens whose ids, drawn from 1-4, recur out of
    order (3, 1, 3, 2, ...), some padding pieces among them."""
    import numpy as np
    import torch
    seg = np.zeros((b, L), np.int32)
    for bi in range(b):
        off = 0
        while off < L:
            n = int(rng.integers(1, 151))
            seg[bi, off:off + n] = int(rng.integers(0, 5))
            off += n
    return torch.from_numpy(seg).to(device)


def long_then_short_seg(rng, L, first, device):
    """One segment of ``first`` tokens, then segments of 5-60 tokens,
    then a padded tail."""
    import numpy as np
    import torch
    seg = np.zeros((1, L), np.int32)
    seg[0, :first] = 1
    off, sid = first, 2
    while off < L - 40:
        n = int(rng.integers(5, 61))
        seg[0, off:min(off + n, L - 40)] = sid
        off, sid = off + n, sid + 1
    return torch.from_numpy(seg).to(device)


def leading_pad_seg(rng, b, L, pads, device):
    """Row i starts with ``pads[i]`` padding tokens (a whole row of them
    when it is L), then 3 segments."""
    import numpy as np
    import torch
    seg = np.zeros((b, L), np.int32)
    for bi, pad in enumerate(pads):
        if pad >= L:
            continue
        cuts = np.sort(rng.choice(np.arange(pad + 1, L), 2, replace=False))
        for sid, (lo, hi) in enumerate(zip([pad, *cuts], [*cuts, L])):
            seg[bi, lo:hi] = sid + 1
    return torch.from_numpy(seg).to(device)


def allowed_pairs(seg, causal, window=None) -> int:
    """(query, key) pairs the mask allows: the attention work this
    input needs."""
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    return int(segment_mask(seg, seg, causal, window).sum())


def tile_pairs(vis, lq, lk) -> int:
    """(query, key) pairs inside the visited tile pairs ``vis`` [B, q
    tiles, key tiles] of K1's grid, rows past ``lq`` and keys past ``lk``
    left out."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    dev = vis.device
    rows = (lq - torch.arange(vis.shape[1], device=dev) * fa.K1_BQ
            ).clamp(max=fa.K1_BQ)
    keys = (lk - torch.arange(vis.shape[2], device=dev) * fa.K1_BK
            ).clamp(max=fa.K1_BK)
    return int((vis * rows[:, None] * keys[None, :]).sum())


def walked_pairs(seg, causal) -> int:
    """(query, key) pairs K1 computes: those of the (q tile, key tile)
    pairs ``visited_key_tiles`` keeps."""
    from realhf_tpu_torch.ops import flash_attention as fa
    L = seg.shape[1]
    return tile_pairs(fa.visited_key_tiles(seg, causal), L, L)


def dkv_walked_pairs(seg, causal) -> int:
    """(query, key) pairs K3 computes: those of the (key tile, q tile)
    pairs ``visited_q_tiles`` keeps (K1's and K2's pairs, transposed)."""
    from realhf_tpu_torch.ops import flash_attention as fa
    L = seg.shape[1]
    return tile_pairs(fa.visited_q_tiles(seg, causal), L, L)


def ring_walked_pairs(seg, n, n_dirs, causal, window=None) -> int:
    """(query, key) pairs K6 computes over a whole ring of ``n`` members
    on the stream ``seg`` [B, L]: summed over members, rounds and
    directions, those of the (warpgroup, key tile) pairs that
    ``visited_key_tiles`` keeps for the member's q shard against the KV
    half it holds, on global offsets."""
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    lc = seg.shape[1] // n
    lch = lc // n_dirs
    total = 0
    for j in range(n):
        seg_q = seg[:, j * lc:(j + 1) * lc]
        for r in range(n):
            for k_off in rf.round_key_offsets(j, r, n, lc, lch, n_dirs):
                vis = fa.visited_key_tiles(
                    seg_q, causal, seg_k=seg[:, k_off:k_off + lch],
                    q_off=j * lc, k_off=k_off, window=window)
                total += tile_pairs(vis, lc, lch)
    return total


def shifted_boundaries(seg):
    """The segment ids moved one token later along the stream: every
    segment boundary shifts by one token."""
    import torch
    out = seg.clone()
    out[:, 1:] = seg[:, :-1]
    return out


def check_flash_fwd(name, b, L, nq, nkv, hd, seg, causal, gen, timed,
                    plant_fault=False):
    """K1 against its plain version. With ``plant_fault``, the kernel's
    output is also held against the plain version on segment boundaries
    shifted by one token, which must exceed the row-error limit."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    dev = seg.device
    q = torch.randn((b, L, nq, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, L, nkv, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, L, nkv, hd), generator=gen, device=dev).bfloat16()
    o, lse = fa.flash_attention(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, seg, causal=causal)
    valid_rows = (lse_ref > NEG_INF / 2)
    o_rows = valid_rows.transpose(1, 2)             # [B, L, nq]
    err_lse = max_err(torch.where(valid_rows, lse, 0.0),
                      torch.where(valid_rows, lse_ref, 0.0))
    lse_sentinel_ok = bool((lse[~valid_rows] == NEG_INF).all())
    rec = dict(kernel="flash_fwd", case=name, shape=[b, L, nq, nkv, hd],
               causal=causal, max_abs_err=max_err(o, o_ref),
               row_rel_err=row_rel_err(o, o_ref, o_rows),
               row_rel_limit=LIMITS["flash_fwd_row_rel"],
               lse_max_abs_err=err_lse, lse_limit=LIMITS["flash_fwd_lse"],
               masked_rows_zero=bool((o.float()[~o_rows] == 0).all()),
               lse_sentinel_ok=lse_sentinel_ok,
               finite=bool(torch.isfinite(o.float()).all()))
    rec["ok"] = (rec["row_rel_err"] <= LIMITS["flash_fwd_row_rel"]
                 and err_lse <= LIMITS["flash_fwd_lse"] and rec["finite"]
                 and rec["masked_rows_zero"] and lse_sentinel_ok)
    rec["walked_pairs"] = walked_pairs(seg, causal)
    rec["allowed_pairs"] = allowed_pairs(seg, causal)
    if plant_fault:
        o_bad, lse_bad = fa.flash_attention_plain(
            q, k, v, shifted_boundaries(seg), causal=causal)
        rows = o_rows & (lse_bad > NEG_INF / 2).transpose(1, 2)
        rec["planted_fault"] = "segment boundaries shifted by one token"
        rec["planted_fault_row_rel_err"] = row_rel_err(o, o_bad, rows)
        rec["ok"] &= (rec["planted_fault_row_rel_err"]
                      > LIMITS["flash_fwd_row_rel"])
    if timed:
        scale = hd ** -0.5
        rec["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, seg,
                                                       causal=causal))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, seg, causal=causal), iters=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = fa.segment_mask(seg, seg, causal)[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec["library_ms"] = (cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                  scale=scale))
                             if nq == nkv else None)
        flops = 4.0 * hd * rec["allowed_pairs"] * nq
        # q/k/v rows of pad tokens (seg 0) are never needed; o and lse
        # are written in full
        tokens = int((seg != 0).sum())
        nbytes = 2 * tokens * (nq + 2 * nkv) * hd + 2 * o.numel() \
            + 4 * (seg.numel() + lse.numel())
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        rec["flops"], rec["bytes"] = flops, nbytes
    return rec


def check_flash_bwd(name, b, L, nq, nkv, hd, seg, causal, gen, timed,
                    plant_fault=False):
    """K2 (dq) and K3 (dk, dv) from K1's o and lse, against the plain
    backward on the same bf16 values widened to fp32; a second launch of
    each must give the same bits. With ``plant_fault``, the backward is
    also run with o = 0 (so delta = 0), which must exceed the dk limit,
    and the kernels' dq and dk are held against the plain backward on
    segment boundaries shifted by one token, which must exceed the dq and
    dk limits (a skip rule too tight at the edges of a segment would pass
    it)."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    dev = seg.device
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, L, nq, hd), (b, L, nkv, hd), (b, L, nkv, hd)))
    do = torch.randn((b, L, nq, hd), generator=gen, device=dev).bfloat16()
    o, lse = fa.flash_attention(q, k, v, seg, causal=causal)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, do, lse, delta, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), seg,
                                       o.float(), lse, do.float(),
                                       causal=causal)
    tok = seg != 0                                   # [B, L]
    q_rows = tok[:, :, None].expand(b, L, nq)
    kv_rows = tok[:, :, None].expand(b, L, nkv)
    rec = dict(kernel="flash_bwd", case=name, shape=[b, L, nq, nkv, hd],
               causal=causal, tokens=int(tok.sum()))
    for key, got, want, rows in (("dq", dq, ref[0], q_rows),
                                 ("dk", dk, ref[1], kv_rows),
                                 ("dv", dv, ref[2], kv_rows)):
        rec[f"{key}_max_abs_err"] = max_err(got, want)
        rec[f"{key}_row_rel_err"] = row_rel_err(got, want, rows, 0.01)
        rec[f"{key}_row_rel_limit"] = LIMITS[f"flash_bwd_{key}_row_rel"]
        rec[f"{key}_pad_rows_zero"] = bool((got.float()[~rows] == 0).all())
        rec[f"{key}_finite"] = bool(torch.isfinite(got.float()).all())
    dq2 = fa.flash_bwd_dq(q, k, v, seg, do, lse, delta, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta, causal=causal)
    rec["deterministic"] = all(torch.equal(x, y) for x, y in
                               ((dq, dq2), (dk, dk2), (dv, dv2)))
    del dq2, dk2, dv2
    rec["ok"] = rec["deterministic"] and all(
        rec[f"{key}_row_rel_err"] <= rec[f"{key}_row_rel_limit"]
        and rec[f"{key}_pad_rows_zero"] and rec[f"{key}_finite"]
        for key in ("dq", "dk", "dv"))
    rec["walked_pairs"] = walked_pairs(seg, causal)
    rec["dkv_walked_pairs"] = dkv_walked_pairs(seg, causal)
    rec["allowed_pairs"] = allowed_pairs(seg, causal)
    if plant_fault:
        _, dk_bad, _ = fa.flash_attention_bwd(q, k, v, seg,
                                              torch.zeros_like(o), lse, do,
                                              causal=causal)
        rec["planted_fault"] = "delta taken as 0 (o = 0)"
        rec["planted_fault_dk_row_rel_err"] = row_rel_err(dk_bad, ref[1],
                                                          kv_rows, 0.01)
        rec["ok"] &= (rec["planted_fault_dk_row_rel_err"]
                      > LIMITS["flash_bwd_dk_row_rel"])
        del dk_bad
        shifted = shifted_boundaries(seg)
        bad = fa.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), shifted, o.float(), lse,
            do.float(), causal=causal)
        both = tok & (shifted != 0)
        rec["planted_fault_2"] = "segment boundaries shifted by one token"
        for key, got, want, heads in (("dq", dq, bad[0], nq),
                                      ("dk", dk, bad[1], nkv)):
            err = row_rel_err(got, want,
                              both[:, :, None].expand(b, L, heads), 0.01)
            rec[f"planted_fault_2_{key}_row_rel_err"] = err
            rec["ok"] &= err > LIMITS[f"flash_bwd_{key}_row_rel"]
        del bad
    if timed:
        kw = dict(causal=causal)
        rec["dq_ms"] = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, seg, do, lse,
                                                       delta, **kw))
        rec["dkv_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, seg, do,
                                                         lse, delta, **kw))
        # the plain version computes dq, dk and dv together
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, seg, o, lse, do, **kw), iters=3, warmup=1)
        rec["library_ms"] = (sdpa_backward_ms(q, k, v, seg, do, causal)
                             if nq == nkv else None)
        # only the (query, key) pairs the mask allows, and only the rows
        # of tokens with seg != 0; lse, delta and seg read once, outputs
        # written once in full
        pairs = allowed_pairs(seg, causal) * nq
        tokens = rec["tokens"]
        stats = 4 * (2 * lse.numel() + seg.numel())
        rec["dq_flops"] = 6.0 * hd * pairs
        rec["dq_bytes"] = 2 * tokens * (2 * nq + 2 * nkv) * hd + stats \
            + 2 * dq.numel()
        rec["dkv_flops"] = 8.0 * hd * pairs
        rec["dkv_bytes"] = 2 * tokens * (2 * nq + 2 * nkv) * hd + stats \
            + 2 * (dk.numel() + dv.numel())
        rec["dq_bound_ms"], rec["dq_bound_by"] = bound_ms(rec["dq_flops"],
                                                          rec["dq_bytes"])
        rec["dkv_bound_ms"], rec["dkv_bound_by"] = bound_ms(
            rec["dkv_flops"], rec["dkv_bytes"])
    del ref
    torch.cuda.empty_cache()
    return rec


def sdpa_backward_ms(q, k, v, seg, do, causal) -> float:
    """The yardstick: the backward of ``scaled_dot_product_attention``
    with the same boolean mask (dq, dk and dv together). Timed only;
    the port never calls it."""
    import torch
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = segment_mask(seg, seg, causal)[:, None]
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)
    g = do.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                               retain_graph=True))


def sft_stream_seg(rng, n_segs, L, device):
    """One packed stream of ``n_segs`` sequences of random lengths with
    a padded tail, as the SFT packer lays out a microbatch."""
    import numpy as np
    import torch
    lens = rng.integers(L // (2 * n_segs), 2 * L // n_segs, size=n_segs)
    lens = (lens * (L - 37) / lens.sum()).astype(int)
    seg = np.zeros((1, L), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i + 1
        off += n
    return torch.from_numpy(seg).to(device)


def phase_kernels_bwd():
    """K2/K3 cases: the SFT microbatch shape (timed, with the planted
    faults), GQA 32/8 and 32/4, hd 64 (the "1b" shape), ragged L,
    non-causal, an all-padding row, and K1's tile-skipping edges: ids
    that recur out of order (causal and not), one long segment then short
    ones, rows whose first q tiles are all padding (hd 64)."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rng = np.random.default_rng(1)
    recs = [check_flash_bwd("sft_microbatch", 1, 4096, 32, 32, 128,
                            sft_stream_seg(rng, 8, 4096, "cuda"), True, gen,
                            timed=True, plant_fault=True)]
    seg = packed_seg(rng, 2, 1024, 4, {1}, "cuda")   # row 1 all padding
    recs.append(check_flash_bwd("gqa_32_8_padrow", 2, 1024, 32, 8, 128, seg,
                                True, gen, timed=False))
    seg = sft_stream_seg(rng, 4, 2048, "cuda")
    recs.append(check_flash_bwd("gqa_32_4_hd64", 1, 2048, 32, 4, 64, seg,
                                True, gen, timed=False))
    seg = packed_seg(rng, 2, 700, 3, set(), "cuda")   # ragged last tile
    recs.append(check_flash_bwd("ragged_L700", 2, 700, 8, 8, 128, seg,
                                True, gen, timed=False))
    recs.append(check_flash_bwd("noncausal_ragged_gqa", 2, 700, 8, 2, 64,
                                seg, False, gen, timed=False))
    for causal in (True, False):
        recs.append(check_flash_bwd(
            f"recurring_ids_causal{int(causal)}", 2, 1000, 16, 8, 128,
            recurring_seg(rng, 2, 1000, "cuda"), causal, gen, timed=False,
            plant_fault=causal))
    recs.append(check_flash_bwd(
        "long_then_short", 1, 2100, 16, 16, 128,
        long_then_short_seg(rng, 2100, 1500, "cuda"), True, gen,
        timed=False, plant_fault=True))
    recs.append(check_flash_bwd(
        "leading_pad_tiles_hd64", 3, 777, 8, 2, 64,
        leading_pad_seg(rng, 3, 777, (300, 0, 777), "cuda"), True, gen,
        timed=False))
    del gen
    torch.cuda.empty_cache()
    return recs


def queued_ms(calls, reps=3, tries=4):
    """Device ms per call of ``calls`` (thunks) run back to back, the
    launches queued ahead of the device: ``torch.cuda._sleep`` holds the
    stream while the host enqueues them all, so the events between the
    first and the last launch time the device alone, not the host's
    enqueue rate. The median of ``reps`` rounds (after one warm-up
    round), the host us per call of the same loop, and whether every
    round's enqueue ended inside the sleep: a round whose enqueue
    outlasts it (a host stall) is taken again with the sleep doubled, up
    to ``tries`` times, and a reading that never fits is still returned,
    marked ``False``."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(1_000_000)
    ev[1].record()
    ev[1].synchronize()
    cycles_per_ms = 1e6 / ev[0].elapsed_time(ev[1])
    sleep_ms = 5.0 + 0.2 * len(calls)
    dev, host, queued = [], [], True
    for _ in range(reps):
        for attempt in range(tries):
            torch.cuda.synchronize()
            ev[0].record()
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            ev[1].record()
            t0 = time.perf_counter()
            for c in calls:
                c()
            host_s = time.perf_counter() - t0
            ev[2].record()
            ev[2].synchronize()
            fits = host_s * 1e3 < ev[0].elapsed_time(ev[1])
            if fits:
                break
            sleep_ms *= 2
        queued &= fits
        dev.append(ev[1].elapsed_time(ev[2]) / len(calls))
        host.append(host_s * 1e6 / len(calls))
    return sorted(dev)[reps // 2], sorted(host)[reps // 2], queued


def decode_valid(b, S, spans, device):
    """[b, S] bool: stream i valid on the slot intervals of ``spans[i]``,
    one (lo, hi) or a list of them (low invalid slots: left padding)."""
    import torch
    valid = torch.zeros((b, S), dtype=torch.bool, device=device)
    for i, sp in enumerate(spans):
        for lo, hi in ([sp] if isinstance(sp[0], int) else sp):
            valid[i, lo:hi] = True
    return valid


def walked_slots(keep) -> int:
    """Cache slots in the tiles the decode kernel walks (the tiles that
    hold a kept slot), over all streams (``decode_split_plan``)."""
    from realhf_tpu_torch.ops import decode_attention as da
    S = keep.shape[1]
    return sum(min(da.TILE, S - t * da.TILE)
               for tiles in da.decode_split_plan(keep.cpu()) for t in tiles)


def check_flash_decode(name, b, S, nq, nkv, hd, spans, gen, timed,
                       stacked_layers=0, layer=0, window=None):
    """K4 (or, with ``stacked_layers``, K5 at ``layer``) against
    ``decode_attention_plain`` at one shape: out rows, m and l (every
    stream, the empty ones included), empty rows exactly 0, two launches
    bit-equal; planted faults: the newest kept slot of every stream
    dropped, and warp 1's partial left out of the kernel's merge. Timed
    cases rotate over enough layer caches (>= 200 MB, four at least)
    that each launch finds its cache cold, as a decode step does, and time
    the kernel and SDPA queued ahead of the device (``queued_ms``;
    ``queued`` says whether every round's enqueue fitted its sleep);
    ``warm_ms`` is the older reading (CUDA events over 20 back-to-back
    calls on one cache)."""
    import torch
    from realhf_tpu_torch.ops import decode_attention as da
    dev = "cuda"
    q = torch.randn((b, nq, hd), generator=gen, device=dev).bfloat16()
    layer_bytes = 2 * b * nkv * S * hd * 2
    n_rot = max(4, -(-200_000_000 // layer_bytes)) if timed else 1
    nl = max(stacked_layers, n_rot)
    shape = (nl, b, nkv, S, hd)
    k_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
    valid = decode_valid(b, S, spans, dev)
    slot = None
    if window is not None:  # the newest slot of each stream
        slot = (S - 1 - valid.flip(-1).int().argmax(-1)).int()
    keep = da.window_keep(valid, window, slot)
    kw = dict(sliding_window=window, slot=slot)

    def call(valid_mask, li=layer, **extra):
        if stacked_layers:
            return da.flash_decode_attention_stacked(
                q, k_all, v_all, valid_mask, li, **kw, **extra)
        return da.flash_decode_attention(q, k_all[li], v_all[li],
                                         valid_mask, **kw, **extra)

    out, m, l = call(valid, return_stats=True)
    again = call(valid, return_stats=True)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k_all[layer], v_all[layer], keep,
                                    return_stats=True)
    rows = keep.any(-1)[:, None].expand(b, nq)     # non-empty streams
    limit = LIMITS["flash_decode_row_rel"]
    # planted fault: the newest kept slot of every stream dropped
    newest = S - 1 - keep.flip(-1).int().argmax(-1)
    dropped = valid.clone()
    dropped[torch.arange(b, device=dev)[rows[:, 0]], newest[rows[:, 0]]] = \
        False
    fault = row_rel_err(call(dropped), ref[0], rows)
    rec = dict(kernel="flash_decode_stacked" if stacked_layers
               else "flash_decode", case=name, shape=[b, S, nq, nkv, hd],
               layer=layer, window=window,
               max_abs_err=max_err(out, ref[0]),
               row_rel_err=row_rel_err(out, ref[0], rows),
               row_rel_limit=limit, planted_fault_row_rel_err=fault,
               empty_rows_zero=bool((out.float()[~rows] == 0).all()),
               finite=bool(torch.isfinite(out.float()).all()),
               deterministic=all(torch.equal(x, y)
                                 for x, y in zip((out, m, l), again)),
               kept_slots=int(keep.sum()), walked_slots=walked_slots(keep))
    rec["m_max_abs_err"] = max_err(m, ref[1])
    rec["l_max_rel_err"] = float(((l - ref[2]).abs()
                                  / ref[2].abs().clamp_min(1e-6)).max())
    rec["ok"] = (rec["row_rel_err"] <= limit and fault > limit
                 and rec["empty_rows_zero"] and rec["finite"]
                 and rec["deterministic"]
                 and rec["m_max_abs_err"] <= LIMITS["flash_decode_m"]
                 and rec["l_max_rel_err"] <= LIMITS["flash_decode_l_rel"])

    # planted fault in the merge: warp 1's partial left out
    rec["merge_fault_row_rel_err"] = row_rel_err(
        da._launch(q, k_all[layer], v_all[layer], valid, window, slot,
                   hd ** -0.5, False, drop_warp=1), ref[0], rows)
    rec["ok"] &= rec["merge_fault_row_rel_err"] > limit
    del out, m, l, again, ref
    if timed:
        n = n_rot * max(1, -(-24 // n_rot))
        rot = [i % n_rot for i in range(n)]
        rec["rotated_layers"], rec["rotated_mb"] = n_rot, n_rot * layer_bytes / 1e6
        rec["ms"], rec["host_us"], rec["queued"] = queued_ms(
            [lambda i=i: call(valid, i) for i in rot])
        rec["warm_ms"] = cuda_ms(lambda: call(valid))
        rec["plain_ms"] = cuda_ms(lambda: da.decode_attention_plain(
            q, k_all[layer], v_all[layer], keep), iters=5, warmup=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, mask = q[:, :, None, :], keep[:, None, None, :] > 0
        gqa = dict(enable_gqa=True) if nq != nkv else {}
        rec["library_ms"], rec["library_host_us"], lib_queued = queued_ms(
            [lambda i=i: sdpa(q4, k_all[i], v_all[i], attn_mask=mask, **gqa)
             for i in rot])
        rec["queued"] &= lib_queued
        # K/V bytes of the kept slots only: the others are never needed
        kept = rec["kept_slots"]
        flops = 4.0 * hd * kept * nq
        nbytes = (2 * (q.numel() * 2 + 2 * kept * nkv * hd) + valid.numel()
                  + (4 * b if window is not None else 0))
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        rec["flops"], rec["bytes"] = flops, nbytes
    del k_all, v_all
    return rec


def phase_kernels():
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    recs = []
    # K1 at the main path's prefill shape: 8 left-padded prompts, L 512
    lengths = [int(x) for x in rng.integers(100, 513, size=8)]
    lengths[0] = 512
    seg = left_padded_seg(lengths, 512, "cuda")
    recs.append(check_flash_fwd("main_prefill", 8, 512, 32, 32, 128, seg,
                                True, gen, timed=True))
    # GQA 32/8, L 500 (ragged last tile), multi-segment rows, one all-pad row
    seg = packed_seg(rng, 4, 500, 3, {2}, "cuda")
    recs.append(check_flash_fwd("gqa_packed_ragged", 4, 500, 32, 8, 128, seg,
                                True, gen, timed=False))
    # the sft path's microbatch: one stream of ~4 k tokens in 8 segments
    seg = sft_stream_seg(rng, 8, 4096, "cuda")
    recs.append(check_flash_fwd("sft_microbatch", 1, 4096, 32, 32, 128, seg,
                                True, gen, timed=True, plant_fault=True))
    # hd 64, causal and not
    seg = packed_seg(rng, 3, 256, 2, {1}, "cuda")
    for causal in (True, False):
        recs.append(check_flash_fwd(f"hd64_causal{int(causal)}", 3, 256, 16,
                                    4, 64, seg, causal, gen, timed=False))
    # the tile-skipping rule at its edges: ids that recur out of order,
    # one segment over many tiles then short ones, and a row whose first
    # q tiles are all padding
    for causal in (True, False):
        recs.append(check_flash_fwd(
            f"recurring_ids_causal{int(causal)}", 2, 1000, 16, 8, 128,
            recurring_seg(rng, 2, 1000, "cuda"), causal, gen, timed=False,
            plant_fault=causal))
    recs.append(check_flash_fwd(
        "long_then_short", 1, 2100, 16, 16, 128,
        long_then_short_seg(rng, 2100, 1500, "cuda"), True, gen,
        timed=False, plant_fault=True))
    recs.append(check_flash_fwd(
        "leading_pad_tiles_hd64", 3, 777, 8, 2, 64,
        leading_pad_seg(rng, 3, 777, (300, 0, 777), "cuda"), True, gen,
        timed=False))
    # K4 at the main path's decode shape: B 8, S 640, MHA; low slots of
    # each stream invalid (left padding), stream 5 empty
    spans = [(512 - n, 512 + 64) for n in lengths]
    spans[5] = (0, 0)
    recs.append(check_flash_decode("main_decode_mha", 8, 640, 32, 32, 128,
                                   spans, gen, timed=True))
    recs.append(check_flash_decode("gqa_32_4", 8, 640, 32, 4, 128, spans,
                                   gen, timed=False))
    recs.append(check_flash_decode("gqa_32_8", 8, 640, 32, 8, 128, spans,
                                   gen, timed=True))
    recs.append(check_flash_decode("hd64_ragged_s", 4, 200, 8, 8, 64,
                                   [(10, 150), (0, 200), (0, 0), (199, 200)],
                                   gen, timed=False))
    # the tile walk at its edges: one stream, a sliding window, a stream
    # whose one kept slot is in the last tile, streams whose kept slots
    # leave whole tiles out in between
    recs.append(check_flash_decode("b1", 1, 640, 32, 32, 128, [(212, 576)],
                                   gen, timed=False))
    recs.append(check_flash_decode("window_96", 8, 640, 32, 8, 128, spans,
                                   gen, timed=False, window=96))
    recs.append(check_flash_decode(
        "last_tile_only", 4, 640, 32, 8, 128,
        [(639, 640), (0, 640), (300, 400), (0, 0)], gen, timed=False))
    recs.append(check_flash_decode(
        "interior_holes", 4, 700, 16, 4, 64,
        [[(10, 60), (300, 310), (600, 700)], [(0, 64), (192, 256)],
         [(5, 6), (699, 700)], [(130, 131), (131, 140), (450, 460)]],
        gen, timed=False))
    # K5: a middle layer of a stacked cache, same per-layer shape as K4
    recs.append(check_flash_decode("stacked_mid_layer", 8, 640, 32, 32, 128,
                                   spans, gen, timed=True, stacked_layers=4,
                                   layer=2))
    del gen
    torch.cuda.empty_cache()
    return recs


# ----------------------------------------------------------------------
# phase 3, K6: the ring against the plain ring
# ----------------------------------------------------------------------
PEAK_LINK_BYTES = 450e9    # H100 SXM NVLink, each way
CTX_MEMBERS = 4
# the ctx-7b-c4 stream: five documents, then padding (32768 tokens)
CTX_DOCS = (12288, 7168, 6144, 4096, 2816)
CTX_PAD = 256


def member_devices(n):
    """Member i on ``cuda:(i mod cards)``: the members spread over four
    cards when the machine has them, and all sit on cuda:0 (passed
    explicitly) when it has one."""
    import torch
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def doc_stream_seg(docs, pad, device):
    """[1, L] segment ids: the documents one after another, then pad."""
    import torch
    seg = torch.zeros((1, sum(docs) + pad), dtype=torch.int32, device=device)
    off = 0
    for i, n in enumerate(docs):
        seg[0, off:off + n] = i + 1
        off += n
    return seg


def ring_shards(t, devs):
    """[B, L, ...] -> member i's contiguous i-th shard along L on devs[i]."""
    lc = t.shape[1] // len(devs)
    return [t[:, i * lc:(i + 1) * lc].to(d).contiguous()
            for i, d in enumerate(devs)]


def ring_gather(shards):
    import torch
    return torch.cat([s.to("cuda:0") for s in shards], dim=1)


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def ring_bound(seg, devs, nq, nkv, hd, causal, window):
    """The least time for the ring's work on these cards, counting only
    what the function needs: per card the FLOPs of the (query, key) pairs
    its members' rows are allowed; the HBM bytes of their q/k/v rows of
    seg != 0 tokens, o and seg; and the NVLink bytes of the k/v/seg rows
    of its shards that a query on another card is allowed to see, once
    per such card (sent by this card, received by that one, each way at
    ``PEAK_LINK_BYTES``). Not what the ring schedule moves: a row no
    other card needs need not leave its card. The slowest card's largest
    term."""
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    n = len(devs)
    b, L = seg.shape
    lc = L // n
    mask = segment_mask(seg, seg, causal, window)   # [B, Lq, Lk]
    row_bytes = 2 * 2 * nkv * hd + 4
    shards = {}
    for j, d in enumerate(devs):
        shards.setdefault(d, []).append(slice(j * lc, (j + 1) * lc))
    cards = {d: dict(flops=0.0, bytes=0.0, link_out=0.0, link_in=0.0)
             for d in shards}
    for d, rows in shards.items():
        c = cards[d]
        for r in rows:
            c["flops"] += 4.0 * hd * nq * float(mask[:, r].sum())
            tokens = int((seg[:, r] != 0).sum())
            c["bytes"] += 2 * tokens * (nq + 2 * nkv) * hd \
                + 2 * b * lc * nq * hd + 4 * b * lc
    for src, keys in shards.items():
        for dst, queries in shards.items():
            if dst == src:
                continue
            for kr in keys:
                need = keys_seen(mask, queries, kr)
                cards[src]["link_out"] += need * row_bytes
                cards[dst]["link_in"] += need * row_bytes
    times = []
    for c in cards.values():
        terms = {"operations": c["flops"] / PEAK_BF16_FLOPS,
                 "bytes": max(c["bytes"] / PEAK_BYTES,
                              max(c["link_out"], c["link_in"])
                              / PEAK_LINK_BYTES)}
        times.append((max(terms.values()), max(terms, key=terms.get)))
    t, by = max(times)
    return t * 1e3, by, {str(d): c for d, c in cards.items()}


def keys_seen(mask, query_slices, key_slice) -> int:
    """How many (stream, key) of ``key_slice`` some query of
    ``query_slices`` may see under ``mask`` [B, Lq, Lk]."""
    need = None
    for qr in query_slices:
        seen = mask[:, qr, key_slice].any(dim=1)
        need = seen if need is None else need | seen
    return int(need.sum())


def check_ring(name, b, n, nq, nkv, hd, seg, gen, **kw):
    """K6 on random bf16 q/k/v over the stream ``seg`` [B, L], sharded
    over ``member_devices(n)``: ``compare_ring``."""
    import torch
    devs = member_devices(n)
    q = torch.randn((b, seg.shape[1], nq, hd), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((b, seg.shape[1], nkv, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    shards = [ring_shards(t, devs) for t in (q, k, v, seg)]
    del q, k, v
    return compare_ring(name, *shards, **kw)


def compare_ring(name, qs, ks, vs, segs, *, causal=True, window=None,
                 scale=None, bidirectional=True, timed=False,
                 plant_faults=False):
    """K6 (ring_attention_fused on CUDA members) against
    ring_attention_plain on the same bf16 values widened to fp32, with
    the members on the devices their shards lie on: the largest error of
    a row over that row's RMS, padding rows exactly 0. With
    ``plant_faults``, two broken rings must exceed the limit: member 1
    skipping round 1, and local in place of global offsets."""
    import torch
    from realhf_tpu_torch.ops import ring_attention as ra
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    devs = [t.device for t in qs]
    n = len(qs)
    b, lc, nq, hd = qs[0].shape
    nkv = ks[0].shape[2]
    L = n * lc
    seg = ring_gather(segs)
    kw = dict(causal=causal, sliding_window=window, scale=scale)

    def call():
        return rf.ring_attention_fused(qs, ks, vs, segs,
                                       bidirectional=bidirectional, **kw)

    def plain():
        return ra.ring_attention_plain(
            [t.float() for t in qs], [t.float() for t in ks],
            [t.float() for t in vs], segs, block_q=1024, block_k=1024, **kw)

    with torch.no_grad():
        o = ring_gather(call())
        sync_all()
        ref = ring_gather(plain())
    rows = (seg != 0)[:, :, None].expand(b, L, nq)
    limit = LIMITS["ring_row_rel"]
    n_dirs = rf._plan_dirs(lc, 512, bidirectional)[0] if n > 1 else 1
    rec = dict(kernel="ring_attention", case=name, shape=[b, L, nq, nkv, hd],
               members=n, member_devices=[str(d) for d in devs], lc=lc,
               n_dirs=n_dirs, causal=causal, sliding_window=window,
               max_abs_err=max_err(o, ref), row_rel_err=row_rel_err(o, ref, rows),
               row_rel_limit=limit,
               masked_rows_zero=bool((o.float()[~rows] == 0).all()),
               finite=bool(torch.isfinite(o.float()).all()))
    rec["ok"] = (rec["row_rel_err"] <= limit and rec["masked_rows_zero"]
                 and rec["finite"])
    rec["walked_pairs"] = ring_walked_pairs(seg, n, n_dirs, causal, window)
    rec["allowed_pairs"] = allowed_pairs(seg, causal, window)
    if plant_faults:
        orig = rf._launch_round

        def broken(fault):
            calls = [0]

            def launch(q_, seg_q, kv, *a, q_off, k_offs, **kw_):
                i = calls[0]
                calls[0] += 1
                if fault == "skip" and i == n + 1:   # member 1, round 1
                    return
                if fault == "local":
                    lch = kv[0][0].shape[1]
                    q_off, k_offs = 0, [d * lch for d in range(len(kv))]
                orig(q_, seg_q, kv, *a, q_off=q_off, k_offs=k_offs, **kw_)

            rf._launch_round = launch
            try:
                with torch.no_grad():
                    bad = ring_gather(call())
            finally:
                rf._launch_round = orig
            return row_rel_err(bad, ref, rows)

        rec["planted_faults"] = {
            "member 1 skips round 1": broken("skip"),
            "local offsets in place of global": broken("local")}
        rec["ok"] &= all(e > limit for e in rec["planted_faults"].values())
    if timed:
        import torch.nn.functional as tf
        from realhf_tpu_torch.ops.flash_attention import segment_mask
        with torch.no_grad():
            rec["ms"] = cuda_ms(call, iters=3, warmup=1)
            rec["plain_ms"] = cuda_ms(plain, iters=1, warmup=0)
            if nq == nkv:
                mask = segment_mask(seg, seg, causal, window)[:, None]
                qt, kt, vt = (ring_gather(t).transpose(1, 2).contiguous()
                              for t in (qs, ks, vs))
                rec["library_ms"] = cuda_ms(lambda: tf.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale), iters=3, warmup=1)
                del mask, qt, kt, vt
            else:
                rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"], rec["bound_per_card"] = ring_bound(
            seg, devs, nq, nkv, hd, causal, window)
        if n > 1 and len(set(devs)) == 1:
            # the same work with one member per card, for the reading
            # of a machine of n cards (the bound needs no such card)
            rec["bound_ms_card_per_member"], rec["bound_by_card_per_member"], _ \
                = ring_bound(seg, [torch.device("cuda", j) for j in range(n)],
                             nq, nkv, hd, causal, window)
    del o, ref
    torch.cuda.empty_cache()
    return rec


def check_ring_push(b, lch, nkv, hd, gen, timed):
    """The push kernel alone at the ctx path's halves: member 0's six
    ranges (k, v and seg of each direction) into member 1 (direction 0)
    and member n - 1 (direction 1) of ``member_devices``; the copies must
    be bit-exact."""
    import torch
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    devs = member_devices(CTX_MEMBERS)
    src, right, left = devs[0], devs[1], devs[-1]
    pairs = []
    for dst_dev in (right, left):
        k = torch.randn((b, lch, nkv, hd), generator=gen,
                        device="cuda").bfloat16().to(src)
        v = torch.randn_like(k)
        s = torch.randint(0, 9, (b, lch), dtype=torch.int32, device=src)
        pairs += [(t, torch.empty_like(t, device=dst_dev)) for t in (k, v, s)]
    for d in (right, left):
        if d != src:
            rf._enable_peer(src, d)
    with torch.cuda.device(src):
        rf._launch_push(pairs)
    sync_all()
    rec = dict(kernel="ring_push", case="ctx_7b_c4_halves",
               member_devices=[str(d) for d in devs],
               bytes=sum(s.numel() * s.element_size() for s, _ in pairs),
               max_abs_err=max(max_err(s, d.to(src)) for s, d in pairs))
    rec["ok"] = all(torch.equal(s, d.to(src)) for s, d in pairs)
    if timed:
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        with torch.cuda.device(src):
            rec["ms"] = cuda_ms(lambda: rf._launch_push(pairs))
            rec["plain_ms"] = cuda_ms(
                lambda: [d.copy_(s) for s, d in pairs])
            foreach = getattr(torch, "_foreach_copy_", None)
            rec["library_ms"] = (cuda_ms(lambda: foreach(dsts, srcs))
                                 if foreach is not None else None)
        half = rec["bytes"] // 2
        # each range read once and written once; to another card the
        # writes cross NVLink (both directions leave this card)
        link = sum(half for d in (right, left) if d != src)
        local = sum(half for d in (right, left) if d == src)
        t_bytes = (rec["bytes"] + local) / PEAK_BYTES
        t_link = link / PEAK_LINK_BYTES
        rec["bound_ms"], rec["bound_by"] = max(t_bytes, t_link) * 1e3, "bytes"
    del pairs
    torch.cuda.empty_cache()
    return rec


def phase_kernels_ring():
    """K6 cases: the ctx-7b-c4 stream (n 4, lc 8192, 32/32 heads, hd
    128; timed, with the planted faults), GQA 8/2 at hd 64 with ragged
    tiles and an all-padding row, non-causal, a sliding window,
    unidirectional, n 2, n 8, one member and ids that recur across
    shards; then the push kernel at the ctx path's halves."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rng = np.random.default_rng(3)
    main = doc_stream_seg(CTX_DOCS, CTX_PAD, "cuda")
    recs = [check_ring("ctx_7b_c4", 1, CTX_MEMBERS, 32, 32, 128, main, gen,
                       timed=True, plant_faults=True)]
    seg = packed_seg(rng, 3, 800, 4, {1}, "cuda")   # lc 200, halves of 100
    recs.append(check_ring("gqa_8_2_hd64_ragged", 3, 4, 8, 2, 64, seg, gen))
    seg = packed_seg(rng, 2, 2048, 3, set(), "cuda")
    recs.append(check_ring("noncausal", 2, 4, 8, 8, 128, seg, gen,
                           causal=False))
    recs.append(check_ring("window_300", 2, 4, 8, 8, 128, seg, gen,
                           window=300))
    recs.append(check_ring("unidirectional", 2, 4, 8, 8, 128, seg, gen,
                           bidirectional=False))
    recs.append(check_ring("n2", 2, 2, 8, 4, 128, seg, gen))
    seg = packed_seg(rng, 1, 4096, 6, set(), "cuda")
    recs.append(check_ring("n8", 1, 8, 16, 16, 128, seg, gen))
    recs.append(check_ring("n1", 1, 1, 16, 16, 128, seg[:, :1024], gen))
    # ids that recur out of order more than 64 tokens apart, across
    # shards: the residue test on global offsets
    recs.append(check_ring("recurring_ids", 2, 4, 8, 8, 128,
                           recurring_seg(rng, 2, 2048, "cuda"), gen))
    lch = sum(CTX_DOCS + (CTX_PAD,)) // CTX_MEMBERS // 2
    recs.append(check_ring_push(1, lch, 32, 128, gen, timed=True))
    del gen
    torch.cuda.empty_cache()
    return recs


# ----------------------------------------------------------------------
# phases 4-6: the gen experiment through the port's entry points, and
# a profile of one generate call
# ----------------------------------------------------------------------
def write_prompts(path, n, seed, lo=100, hi=512):
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.integers(0, 5000, size=int(rng.integers(lo, hi + 1)))
            f.write(json.dumps({"id": i, "prompt": " ".join(
                f"w{int(w)}" for w in words)}) + "\n")


def reset_counts():
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    da.launches = 0
    da.stacked_launches = 0
    rf.round_launches = rf.push_launches = 0


def read_counts():
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                flash_bwd_dkv=fa.dkv_launches, flash_decode=da.launches,
                flash_decode_stacked=da.stacked_launches,
                ring_round=rf.round_launches, ring_push=rf.push_launches)


def build_gen_spec(data_path, n_layers, max_new_tokens, benchmark_steps):
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.gen_exp import GenerationConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = GenerationConfig(experiment_name="chip-smoke", trial_name="t0",
                           benchmark_steps=benchmark_steps)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.train_bs_n_seqs": "8",
                          "dataset.max_seqlen": "512",
                          "max_new_tokens": str(max_new_tokens),
                          "greedy": "true"})
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.random_init_config = llama_config("7b", n_layers=n_layers)
    mspec.bf16 = True
    vocab = mspec.random_init_config["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return spec, vocab


def check_gen_output(runner, vocab) -> bool:
    import numpy as np
    batch = runner.last_batch
    ids = batch.data["packed_input_ids"]
    return bool(ids.dtype == np.int32 and ids.min() >= 0
                and ids.max() < vocab
                and batch.total_len("packed_input_ids")
                > batch.total_len("packed_prompts"))


def step_summary(st, smi):
    steps = st["decode_steps"]
    return dict(decode_steps=steps, generated_tokens=st["generated_tokens"],
                prefill_ms=st["prefill_secs"] * 1e3,
                decode_ms_per_token=st["decode_secs"] * 1e3 / max(steps, 1),
                generated_tokens_per_s=st["generated_tokens"]
                / (st["prefill_secs"] + st["decode_secs"]),
                card=smi)


def phase_gen(n_layers, max_new_tokens, smi, with_sampled_step):
    """Two greedy steps (one for the deep model) of ``InlineRunner.run``,
    then, with ``with_sampled_step``, one sampled step of a second
    ``run`` call (its step count is already past ``benchmark_steps``)."""
    import torch
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    from realhf_tpu_torch.system.inline import InlineRunner
    greedy_steps = 2 if with_sampled_step else 1
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8 * greedy_steps, seed=1)
        spec, vocab = build_gen_spec(data, n_layers, max_new_tokens,
                                     greedy_steps)
        t0 = time.monotonic()
        runner = InlineRunner(spec)  # device=None: the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
        eng = runner.models["default"].engine
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        runner.run()
        outputs_ok = check_gen_output(runner, vocab)
        if with_sampled_step:
            runner.interfaces["gen"].gconfig = GenerationHyperparameters(
                max_new_tokens=max_new_tokens, greedy=False, top_k=50,
                top_p=0.9, force_no_logits_mask=True)
            runner.run()
            outputs_ok &= check_gen_output(runner, vocab)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = eng.generate_stats
        n_calls = len(stats)
        n_decode = sum(st["decode_steps"] for st in stats)
        decode_key = ("flash_decode_stacked" if n_layers > 48
                      else "flash_decode")
        other_key = ("flash_decode" if n_layers > 48
                     else "flash_decode_stacked")
        counts_ok = (counts["flash_fwd"] == n_layers * n_calls
                     and counts[decode_key] == n_layers * n_decode
                     and counts[other_key] == 0
                     and counts["flash_bwd_dq"] == 0
                     and counts["flash_bwd_dkv"] == 0
                     and counts["ring_round"] == counts["ring_push"] == 0)
        labels = ["greedy"] * greedy_steps + (
            ["sampled_topk50_topp0.9"] if with_sampled_step else [])
        steps = [dict(step=lab, **step_summary(st, smi))
                 for lab, st in zip(labels, stats)]
        del runner, eng
        torch.cuda.empty_cache()
    return dict(n_layers=n_layers, setup_secs=setup,
                steps=steps, generate_calls=n_calls,
                launches=counts, launches_ok=counts_ok,
                outputs_in_range=outputs_ok, peak_mem_gb=peak, card=smi,
                ok=counts_ok and outputs_ok and n_calls == len(labels))


def device_kernel_us(prof):
    """(total kernel time in us, top kernels by time) from a profiler
    run; (None, []) when the trace holds no device events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    top = [dict(kernel=k[:80], us=us, calls=n, share=us / total)
           for k, us, n in rows[:12]]
    return total, top


def phase_profile(smi):
    """Device busy share and kernel breakdown of one 7B generate call
    (8 prompts, 16 greedy new tokens, EOS early-exit checks on): a
    torch.profiler trace of prefill alone, then of the whole call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    cfg = TransformerConfig(**llama_config("7b"), param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    eng = Engine(cfg, T.init_params(cfg, seeding.generator(11, "cuda"),
                                    "cuda"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, 32000, size=int(n)).astype(np.int32)
               for n in rng.integers(100, 513, size=8)]
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    gc = GenerationHyperparameters(max_new_tokens=16, greedy=True,
                                   force_no_logits_mask=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def call():
        return eng.generate(ids, seg, pos, None, gc, eos_token_id=1,
                            pad_token_id=0)

    call()  # warm up
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=acts) as prof_p:
            t0 = time.monotonic()
            T.prefill(cfg, eng.params, t(ids), t(seg), t(pos),
                      total_len=ids.shape[1] + 16)
            torch.cuda.synchronize()
            prefill_wall = time.monotonic() - t0
    with profile(activities=acts) as prof_g:
        t0 = time.monotonic()
        out = call()
        wall = time.monotonic() - t0
    pre_us, pre_top = device_kernel_us(prof_p)
    all_us, all_top = device_kernel_us(prof_g)
    rec = dict(card=smi, decode_steps=out.stats["decode_steps"],
               prefill_wall_ms=prefill_wall * 1e3,
               generate_wall_ms=wall * 1e3)
    if pre_us is None or all_us is None:
        rec["device_time"] = "not measured (no device events in the trace)"
    else:
        steps = out.stats["decode_steps"]
        dec_wall = wall - out.stats["prefill_secs"]
        dec_us = all_us - pre_us
        rec.update(
            prefill_kernel_ms=pre_us / 1e3,
            prefill_busy_share=pre_us / 1e6 / prefill_wall,
            decode_kernel_ms_per_step=dec_us / 1e3 / steps,
            decode_wall_ms_per_step=dec_wall * 1e3 / steps,
            decode_busy_share=dec_us / 1e6 / dec_wall,
            prefill_top=pre_top, generate_top=all_top)
    del eng
    torch.cuda.empty_cache()
    return rec


# ----------------------------------------------------------------------
# phases 7-8: the sft experiment at 7B width, and a profile of one step
# ----------------------------------------------------------------------
SFT_LAYERS = 8


def write_prompt_answers(path, n, seed, lo=100, hi=400):
    import numpy as np
    rng = np.random.default_rng(seed)

    def words(k):
        return " ".join(f"w{int(w)}" for w in rng.integers(0, 5000, size=k))

    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "id": i, "prompt": words(int(rng.integers(lo, hi + 1))),
                "answer": " " + words(int(rng.integers(lo, hi + 1)))}) + "\n")


def build_sft_spec(data_path, n_layers, lr="1e-5"):
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.sft_exp import SFTConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = SFTConfig(experiment_name="chip-smoke", trial_name="sft",
                    total_train_epochs=3)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.valid_path": data_path,
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "1024",
                          "n_mbs": "2", "model.optimizer.lr": lr,
                          "eval_freq_epochs": "3"})
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.random_init_config = llama_config("7b", n_layers=n_layers)
    vocab = mspec.random_init_config["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return spec


def leaf_names(tree, prefix=""):
    """Dotted paths of a param tree in the engine's (sorted) leaf order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaf_names(tree[k], f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out


def grad_slices(name, g, n_layers):
    """A leaf's gradient as rows to judge one by one: one per layer for
    the stacked block leaves, the whole leaf otherwise."""
    return g.reshape(n_layers, -1) if name.startswith("blocks.") \
        else g.reshape(1, -1)


def capture_first_grads(opt):
    """Record the fp32 gradient list of the next optimizer step (the
    accumulated, unclipped sums) by wrapping the optimizer's ``step``;
    the wrapper keeps a reference, which the caller drops."""
    seen = []
    orig = opt.step

    def step(params, grads):
        if not seen:
            seen.append([g.clone() for g in grads])
        return orig(params, grads)

    opt.step = step
    return seen


def phase_sft(smi):
    """The sft experiment through ``SFTConfig.build()`` and
    ``InlineRunner`` at 7B width and 8 layers, bf16, gradient
    checkpointing: 3 epochs over one batch of 16 prompt-answer records
    in 2 microbatches, then eval on the same file. Checks falling loss,
    a finite non-zero gradient for every layer of every leaf on step 1,
    and exact launch counts."""
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    from realhf_tpu_torch.interfaces import common
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        spec = build_sft_spec(data, SFT_LAYERS)
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec))  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    names = leaf_names(eng.params)
    seen = capture_first_grads(eng.optimizer)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng.optimizer.step  # drop the wrapper
    steps = [st["trainDefault"] for st in runner.step_stats]
    losses = [st["loss"] for st in steps]
    loss_ok = (len(losses) == 3
               and all(math.isfinite(x) for x in losses)
               and all(b < a for a, b in zip(losses, losses[1:])))
    grads = {}
    for name, g in zip(names, seen[0] if seen else []):
        rows = grad_slices(name, g, SFT_LAYERS).abs().amax(-1)
        grads[name] = dict(finite=bool(torch.isfinite(g).all()),
                           min_slice_absmax=float(rows.min()))
    grads_ok = (len(grads) == len(names)
                and all(v["finite"] and v["min_slice_absmax"] > 0
                        for v in grads.values()))
    n_eval_batches = len(runner.eval_dataloader)
    evals = [ev for _, _, ev in runner.eval_stats]
    n_bwd = SFT_LAYERS * 2 * 3  # layers x microbatches x steps
    want = dict(flash_fwd=2 * n_bwd + SFT_LAYERS * n_eval_batches * len(evals),
                flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd, flash_decode=0,
                flash_decode_stacked=0, ring_round=0, ring_push=0)
    tokens = runner.last_batch.total_len("packed_input_ids")
    mb_tokens = [mb.total_len("packed_input_ids") for mb in
                 common.split_minibatches(runner.last_batch, 2)]
    rec = dict(n_layers=SFT_LAYERS, setup_secs=setup, card=smi,
               tokens_per_step=tokens, microbatch_tokens=mb_tokens,
               losses=losses,
               grad_norms=[st["grad_norm"] for st in steps],
               step_secs=list(runner.step_secs),
               train_tokens_per_s=[tokens / t for t in runner.step_secs],
               peak_mem_gb=peak, evals=evals, launches=counts,
               launches_expected=want, launches_ok=counts == want,
               loss_strictly_falling=loss_ok, step1_grads_ok=grads_ok,
               step1_grads=grads)
    rec["eval_ok"] = len(evals) == 1 and math.isfinite(evals[0]["loss"])
    rec["ok"] = (loss_ok and grads_ok and rec["launches_ok"]
                 and rec["eval_ok"])
    return runner, rec


def kernel_category(name: str, kernels=("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")) -> str:
    for kernel in kernels:
        if f"{kernel}_kernel" in name:
            return kernel
    if any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def phase_sft_profile(runner, smi):
    """A torch.profiler trace of one more sft step on the same batch:
    device time by kernel category, the optimizer step's device time
    (CUDA events around it) and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    opt = runner.models["default"].engine.optimizer
    orig = opt.step
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(params, grads):
        ev[0].record()
        orig(params, grads)
        ev[1].record()

    opt.step = timed
    batch = runner.last_batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        runner.run_step(batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    del opt.step
    cuda = torch.autograd.DeviceType.CUDA
    by_cat = {}
    for e in prof.key_averages():
        if e.device_type == cuda:
            cat = kernel_category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total
    total_us, top = device_kernel_us(prof)
    rec = dict(card=smi, step_wall_ms=wall * 1e3,
               optimizer_step_ms=ev[0].elapsed_time(ev[1]))
    if total_us is None:
        rec["device_time"] = "not measured (no device events in the trace)"
    else:
        rec.update(kernel_ms=total_us / 1e3,
                   busy_share=total_us / 1e6 / wall,
                   ms_by_category={k: v / 1e3 for k, v in by_cat.items()},
                   share_by_category={k: v / total_us
                                      for k, v in by_cat.items()},
                   optimizer_share=rec["optimizer_step_ms"] * 1e3 / total_us,
                   top=top)
    return rec


# the largest relative loss difference of a step, port against the plain
# fp32 reference at lr 1e-4: about 3x the sound reading (PERF.md, Findings)
LR_WITNESS_LIMIT = 0.025


def phase_sft_lr(smi):
    """The sft cell at lr 1e-4, where its loss rises on step 3: 3 steps
    of the port (bf16, the kernels, through ``InlineRunner``), then 3
    steps of a plain reference on the card from the same initial weights
    and batch: fp32 weights, compute and optimizer state, attention
    through ``packed_attention_plain`` (patched into the model here, for
    this run only) and an fp32 LM head. Each step's loss must agree
    within the limit, and the lr 1e-5 trajectory of phase sft must not
    (so the limit tells trajectories apart)."""
    import dataclasses
    import torch
    from realhf_tpu_torch.api.model import Model
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.interfaces.sft import SFTInterface
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.ops.attention import packed_attention_plain
    from realhf_tpu_torch.system.inline import InlineRunner
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        runner = InlineRunner(without_saves(
            build_sft_spec(data, SFT_LAYERS, lr="1e-4")))
    model = runner.models["default"]
    init = _tree_map(lambda t: t.float(), model.engine.params)  # new fp32
    runner.run()
    port = [st["trainDefault"]["loss"] for st in runner.step_stats]
    batch, cfg = runner.last_batch, model.engine.cfg
    opt_cfg = model.engine.optimizer.cfg
    n_steps = len(port)
    del runner
    model.engine = None
    torch.cuda.empty_cache()
    ref_cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    ref_model = Model(name=model.name, tokenizer=model.tokenizer,
                      engine=Engine(ref_cfg, init, "cuda", optimizer=opt_cfg,
                                    total_train_steps=n_steps))
    del init
    plain_fp32 = (torch.get_float32_matmul_precision() == "highest"
                  and not torch.backends.cuda.matmul.allow_tf32)
    attn, T.packed_attention = T.packed_attention, packed_attention_plain
    t0 = time.monotonic()
    try:
        ref = [SFTInterface().train_step(ref_model, batch, n_mbs=2)["loss"]
               for _ in range(n_steps)]
        torch.cuda.synchronize()
    finally:
        T.packed_attention = attn
    ref_secs = time.monotonic() - t0
    del ref_model
    torch.cuda.empty_cache()

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    rec = dict(card=smi, lr=1e-4, port_losses=port, reference_losses=ref,
               reference="fp32 weights/compute/optimizer, plain attention",
               reference_fp32_matmul=plain_fp32, reference_secs=ref_secs,
               rel_diff=rel(port, ref), limit=LR_WITNESS_LIMIT,
               port_rises_on_last_step=port[-1] > port[-2],
               reference_rises_on_last_step=ref[-1] > ref[-2])
    rec["ok"] = (len(port) == len(ref) == 3 and plain_fp32
                 and all(math.isfinite(x) for x in port + ref)
                 and rec["rel_diff"] <= LR_WITNESS_LIMIT)
    return rec


# ----------------------------------------------------------------------
# phase 9: card against CPU
# ----------------------------------------------------------------------
def phase_parity():
    import numpy as np
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa

    base = llama_config("7b", n_layers=2)
    cfg_gpu = TransformerConfig(**base, param_dtype="bfloat16",
                                compute_dtype="bfloat16")
    cfg_cpu = TransformerConfig(**base, param_dtype="float32",
                                compute_dtype="float32")
    params = T.init_params(cfg_gpu, seeding.generator(7, "cuda"), "cuda")
    params_cpu = _tree_map(lambda t: t.float().cpu(), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 32000, size=n).astype(np.int32)
               for n in (100, 37)]
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    n_steps = 8
    fwd0, dec0 = fa.launches, da.launches

    def run(cfg, p, device, tokens=None):
        with torch.inference_mode():
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            hidden, cache = T.prefill(cfg, p, t(ids), t(seg), t(pos),
                                      total_len=ids.shape[1] + n_steps)
            h = hidden[:, -1]
            lens = t(seg).sum(-1).to(torch.int32)
            logits, chosen = [], []
            for step in range(n_steps):
                lg = T.lm_logits(cfg, p, h).float()
                logits.append(lg.cpu())
                tok = (lg.argmax(-1).to(torch.int32) if tokens is None
                       else t(tokens[step]))
                chosen.append(tok.cpu().numpy())
                h, cache = T.decode_step(cfg, p, cache, tok, lens + step,
                                         uniform_slot=True)
            return torch.stack(logits), chosen

    ref_logits, ref_tokens = run(cfg_cpu, params_cpu, "cpu")
    gpu_logits, gpu_tokens = run(cfg_gpu, params, "cuda", tokens=ref_tokens)
    launched = dict(flash_fwd=fa.launches - fwd0,
                    flash_decode=da.launches - dec0)
    # the LM head on bf16 hidden states against fp32 sums of the same
    # (exact) bf16 products: a result rounded to bf16 first is ~1e-3 off
    hb = torch.randn((4, base["hidden_dim"]), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(5))
    hb = hb.bfloat16()
    head = T.lm_logits(cfg_gpu, params, hb)
    want = hb.float() @ T.head_weight(cfg_gpu, params).float()
    head_rel = float((head - want).abs().max() / want.abs().max())
    scale = float(ref_logits.abs().max())
    err = float((gpu_logits - ref_logits).abs().max())
    # the first greedy token must agree unless the reference's top two
    # logits are closer than the logits' error (not decidable then)
    first_ref = ref_logits[0]
    top2 = first_ref.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1])
    first_gpu = gpu_logits[0].argmax(-1)
    same = first_gpu == first_ref.argmax(-1)
    first_ok = bool((same | (gap < 2 * err)).all())
    agree = float((gpu_logits.argmax(-1) == ref_logits.argmax(-1))
                  .float().mean())
    limit = 0.05
    ok = (err / scale <= limit and first_ok and head.dtype == torch.float32
          and head_rel <= 1e-4
          and bool(torch.isfinite(gpu_logits).all())
          and launched["flash_fwd"] == 2
          and launched["flash_decode"] == 2 * n_steps)
    del params
    torch.cuda.empty_cache()
    return dict(layers=2, prompts=[len(p) for p in prompts],
                decode_steps=n_steps, logits_max_abs_err=err,
                logits_max_abs=scale, rel_err=err / scale, rel_limit=limit,
                first_token_equal=[bool(x) for x in same],
                first_top2_gap=[float(x) for x in gap],
                greedy_agreement=agree, launches=launched,
                lm_head_fp32_rel_err=head_rel, lm_head_rel_limit=1e-4, ok=ok)


# ----------------------------------------------------------------------
# phase 10: one SFT step, card against CPU
# ----------------------------------------------------------------------
# about 3x the readings of a sound step (PERF.md, Findings)
TRAIN_PARITY_LIMITS = dict(loss_rel=1e-4, grad_norm_rel=3e-3, min_cos=0.9997,
                           later_loss_rel=0.022)
TRAIN_PARITY_STEPS = 3


def sft_microbatches(rng, vocab):
    """Two microbatches of two prompt-answer sequences (~510 tokens in
    all, unequal answer counts) and their answer-token weights."""
    import numpy as np
    from realhf_tpu_torch.interfaces import common
    sbs = []
    for lens, plens in (([150, 110], [40, 30]), ([90, 160], [60, 20])):
        ids = rng.integers(2, vocab, size=sum(lens)).astype(np.int32)
        pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)])
        sbs.append(common.build_stream_batch(
            lens, dict(input_ids=ids, prompt_mask=pm)))
    sbs = common.pad_stream_batches(sbs)
    weights = [float((~b.arrays["prompt_mask"] & (b.arrays["seg_ids"] != 0))
                     .sum()) for b in sbs]
    return [b.arrays for b in sbs], weights


def grad_agreement(names, got, ref, n_layers):
    """The cosine similarity of each layer slice of each leaf's
    gradient, card against CPU (0 where either side is all zero), summed
    in fp64: fp32 sums over the 32.8 M-element head read up to 1.0015."""
    cos = {}
    for name, a, b in zip(names, got, ref):
        a = grad_slices(name, a.double().cpu(), n_layers)
        b = grad_slices(name, b.double(), n_layers)
        den = (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30)
        cos[name] = ((a * b).sum(-1) / den).tolist()
    return cos


def phase_train_parity():
    """Three SFT optimizer steps at lr 1e-4 from the same weights and
    microbatches on the card (bf16, the kernels) and on the CPU (fp32,
    the plain versions): step 1's loss, grad norm, and the cosine
    similarity of every layer slice of every leaf's gradient, then the
    loss of steps 2-3. A copy of the card's gradients with layer 1's
    wq/wk/wv zeroed (the fault of a kernel output without a gradient)
    must fail the limits."""
    import numpy as np
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces import sft
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.convert import params_numpy
    nl = 2
    base = dict(llama_config("7b", n_layers=nl), hidden_dim=1024,
                n_q_heads=8, n_kv_heads=8, intermediate_dim=2816,
                gradient_checkpointing=True)
    cfgs = {dev: TransformerConfig(**base, param_dtype=dt, compute_dtype=dt)
            for dev, dt in (("cuda", "bfloat16"), ("cpu", "float32"))}
    # bf16 weights, the same numbers on both sides
    weights = params_numpy(T.init_params(cfgs["cuda"], seeding.generator(5),
                                         "cpu"))
    mbs, loss_w = sft_microbatches(np.random.default_rng(6),
                                   base["vocab_size"])
    opt = OptimizerConfig(lr=1e-4, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)
    out, grads, traj = {}, {}, {}
    for dev, cfg in cfgs.items():
        eng = Engine(cfg, weights, dev, optimizer=opt)
        seen = capture_first_grads(eng.optimizer)
        steps = [eng.train_batch(mbs, sft._make_loss_fn(cfg), loss_w)
                 for _ in range(TRAIN_PARITY_STEPS)]
        out[dev], traj[dev] = steps[0], [st["loss"] for st in steps]
        grads[dev] = seen[0]
        names = leaf_names(eng.params)
        del eng, seen
    torch.cuda.empty_cache()
    cos = grad_agreement(names, grads["cuda"], grads["cpu"], nl)
    faulty = [g.clone() for g in grads["cuda"]]
    for name, g in zip(names, faulty):
        if name in ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv"):
            g[1] = 0
    cos_fault = grad_agreement(names, faulty, grads["cpu"], nl)
    lim = TRAIN_PARITY_LIMITS

    def rel(k):
        return abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])

    min_cos = min(min(v) for v in cos.values())
    max_cos = max(max(v) for v in cos.values())
    fault_min_cos = min(min(v) for v in cos_fault.values())
    later = max(abs(a - b) / abs(b) for a, b in
                zip(traj["cuda"][1:], traj["cpu"][1:]))
    rec = dict(layers=nl, hidden=base["hidden_dim"], tokens=int(
        sum((m["seg_ids"] != 0).sum() for m in mbs)), loss=out,
        loss_rel_err=rel("loss"), grad_norm_rel_err=rel("grad_norm"),
        min_cos=min_cos, max_cos=max_cos, cos=cos, losses=traj,
        later_loss_rel_err=later, limits=lim,
        planted_fault="layer 1 wq/wk/wv gradients zeroed",
        planted_fault_min_cos=fault_min_cos)
    rec["ok"] = (rec["loss_rel_err"] <= lim["loss_rel"]
                 and rec["grad_norm_rel_err"] <= lim["grad_norm_rel"]
                 and lim["min_cos"] <= min_cos and max_cos <= 1 + 1e-6
                 and later <= lim["later_loss_rel"]
                 and all(math.isfinite(x) for x in traj["cuda"])
                 and fault_min_cos < lim["min_cos"])
    return rec


# ----------------------------------------------------------------------
# phases 11-13: the ppo experiment at 7B width, its profile, and card
# against CPU on the same rollout
# ----------------------------------------------------------------------
PPO_LAYERS = 4
PPO_MINIBATCHES = 4
PPO_ROLES = ("actor", "critic", "ref", "reward")
PPO_MFCS = ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
            "critic_train")
# A step's first minibatch runs on the weights that generated, so the
# packed forward (K1, the replayed logits mask) must reproduce the decode
# path's log-probs (K4, per-token LM head): |importance_weight - 1| and
# |ppo_approx_kl|, each about 3x the largest sound reading (PERF.md,
# Findings)
PPO_FIRST_MINIBATCH_LIMITS = dict(importance_weight=3.5e-3,
                                  ppo_approx_kl=3.5e-3)


def build_ppo_spec(data_path, n_layers, benchmark_steps, auto_offload=False,
                   ctx=1):
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name="ppo",
                    benchmark_steps=benchmark_steps)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "512",
                          "ppo.max_new_tokens": "128",
                          "ppo.min_new_tokens": "32",
                          "ppo.ppo_n_minibatches": str(PPO_MINIBATCHES),
                          "actor.optimizer.lr": "1e-5",
                          "critic.optimizer.lr": "1e-5",
                          "ref.parallel.context_parallel_size": str(ctx),
                          "rew.parallel.context_parallel_size": str(ctx)})
    spec = cfg.build()
    spec.auto_offload = auto_offload
    for role in PPO_ROLES:
        spec.models[role].random_init_config = llama_config(
            "7b", n_layers=n_layers)
    vocab = spec.models["actor"].random_init_config["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return spec, vocab


def watch_ppo_runner(runner) -> dict:
    """Wrap, on this runner's own objects, what the script reads and the
    library does not keep: ``host.execute`` (host-clock seconds of each
    MFC, weight reload and offload hook included, up to a device
    synchronisation), each train engine's ``train_minibatches`` (every
    minibatch's own stats; the interface returns their mean) and the
    segment matrices the packer gave each engine call, which are the
    shapes the kernels ran at."""
    import numpy as np
    import torch
    host = runner.host
    seen = dict(mfc_secs={name: [] for name in host.nodes},
                minibatch_stats=dict(actor_train=[], critic_train=[]),
                segs=dict(prefill=[], inference=[], minibatch=[]))
    execute = host.execute

    def timed_execute(name, inp):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = execute(name, inp)
        torch.cuda.synchronize()
        seen["mfc_secs"][name].append(time.monotonic() - t0)
        return out

    host.execute = timed_execute

    def keep_seg(engine, method, kind):
        orig = getattr(engine, method)

        def call(ids, seg, *args, **kw):
            seen["segs"][kind].append(np.asarray(seg))
            return orig(ids, seg, *args, **kw)

        setattr(engine, method, call)

    keep_seg(runner.models["actor"].engine, "generate", "prefill")
    keep_seg(runner.models["reward"].engine, "forward_values", "inference")
    keep_seg(runner.models["ref"].engine, "forward_logprobs", "inference")
    keep_seg(runner.models["critic"].engine, "forward_values", "inference")
    for role in ("actor", "critic"):
        engine = runner.models[role].engine

        def train_minibatches(minibatches, *args, _role=role,
                              _orig=engine.train_minibatches, **kw):
            seen["segs"]["minibatch"] += [mb["seg_ids"] for mbs in minibatches
                                          for mb in mbs]
            out = _orig(minibatches, *args, **kw)
            seen["minibatch_stats"][f"{_role}_train"].append(out)
            return out

        engine.train_minibatches = train_minibatches
    return seen


def expected_ppo_launches(n_layers, n_minibatches, gen_stats):
    """Per generate call: K1 once per layer in prefill, K4 once per layer
    per decode step. Per step: K1 once per layer in each of rew_inf,
    ref_inf and critic_inf (one chunk each), and in each train MFC per
    minibatch (one microbatch) a forward and a checkpoint recompute;
    K2 and K3 once per layer per minibatch per train MFC."""
    steps = len(gen_stats)
    bwd = 2 * n_minibatches * n_layers * steps
    return dict(
        flash_fwd=(n_layers + 3 * n_layers) * steps + 2 * bwd,
        flash_bwd_dq=bwd, flash_bwd_dkv=bwd,
        flash_decode=n_layers * sum(st["decode_steps"] for st in gen_stats),
        flash_decode_stacked=0, ring_round=0, ring_push=0)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree_leaves(tree))


def tree_checksum(tree) -> int:
    """Sum of every leaf's 16-bit words, on whichever device it lies."""
    import torch
    return sum(int(t.contiguous().view(torch.int16).sum(dtype=torch.int64))
               for t in _tree_leaves(tree))


def check_ppo_rollout(batch, vocab) -> dict:
    """Tokens in range, every generated token allowed by its own logits
    mask (stored True = masked out), log-probs finite and <= 0."""
    import numpy as np
    ids = batch.data["packed_input_ids"]
    gen_idx = np.flatnonzero(~batch.data["prompt_mask"])
    mask = batch.data["packed_logits_mask"]
    lp = batch.data["packed_logprobs"]
    return dict(
        tokens_in_range=bool(ids.dtype == np.int32 and ids.min() >= 0
                             and ids.max() < vocab),
        tokens_inside_mask=bool(
            not mask[gen_idx - 1, ids[gen_idx]].any()),
        masked_share=float(mask[gen_idx - 1].mean()),
        logprobs_ok=bool(np.isfinite(lp).all() and lp.max() <= 0),
        generated_tokens=int(len(gen_idx)))


def ppo_step_records(runner, mfc_secs, smi):
    recs = []
    eng = runner.models["actor"].engine
    for i, secs in enumerate(runner.step_secs):
        mfc = {name: v[i] for name, v in mfc_secs.items()}
        gen = eng.generate_stats[i]
        st = runner.step_stats[i]["actor_train"]
        tokens = int(st["avg_seq_len"] * st["n_seqs"] + 0.5)
        recs.append(dict(
            step=i + 1, step_secs=secs, mfc_secs=mfc,
            decode_steps=gen["decode_steps"],
            generated_tokens=gen["generated_tokens"],
            generated_tokens_per_s=gen["generated_tokens"] / mfc["actor_gen"],
            batch_tokens=tokens,
            actor_train_tokens_per_s=tokens / mfc["actor_train"],
            critic_train_tokens_per_s=tokens / mfc["critic_train"],
            batch_tokens_per_step_s=tokens / secs, card=smi))
    return recs


def phase_ppo(smi):
    """The ppo experiment through ``PPOConfig.build()`` and
    ``InlineRunner`` at 7B width and 4 layers for all four roles, bf16,
    gradient checkpointing on: 2 steps of 16 prompts (100-512 words), up
    to 128 sampled new tokens (top-p 0.9, top-k 200, logits mask kept),
    4 minibatches per train MFC. Then one step of a second runner with
    ``auto_offload``."""
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    lim = PPO_FIRST_MINIBATCH_LIMITS
    # ``peak_mem_gb`` is the allocator's own peak over the two steps;
    # ``leftover_gb`` is what earlier phases still held when this one
    # began and ``resident_gb`` the four models' and optimizers' bytes
    gc.collect()
    torch.cuda.empty_cache()
    leftover = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        # 10 batches in the file: the lr schedule spans 10 steps, so the
        # 8 optimizer steps of these 2 PPO steps stay inside it
        write_prompts(data, 160, seed=1)
        spec, vocab = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=2)
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec))  # device=None: the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
        resident = torch.cuda.memory_allocated() - leftover
        seen = watch_ppo_runner(runner)
        per_mb = seen["minibatch_stats"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        runner.run()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        actor = runner.models["actor"].engine
        want = expected_ppo_launches(PPO_LAYERS, PPO_MINIBATCHES,
                                     actor.generate_stats)
        firsts = [step[0] for step in per_mb["actor_train"]]
        stats_finite = all(
            math.isfinite(v) for step in runner.step_stats
            for st in step.values() for v in st.values()) and all(
            math.isfinite(v) for seen in per_mb.values() for step in seen
            for st in step for v in st.values())
        rec = dict(
            n_layers=PPO_LAYERS, setup_secs=setup, card=smi,
            leftover_gb=leftover / 2 ** 30,
            resident_gb=resident / 2 ** 30, peak_mem_gb=peak,
            steps=ppo_step_records(runner, seen["mfc_secs"], smi),
            mfc_runs={k: len(v) for k, v in seen["mfc_secs"].items()},
            stats=runner.step_stats,
            minibatch_stats=per_mb,
            first_minibatch=dict(
                importance_weight=[m["importance_weight"] for m in firsts],
                ppo_approx_kl=[m["ppo_approx_kl"] for m in firsts],
                limits=lim),
            rollout=check_ppo_rollout(runner.last_batch, vocab),
            versions={r: dict(model=runner.models[r].version.global_step,
                              engine=runner.models[r].engine.version)
                      for r in ("actor", "critic")},
            launches=counts, launches_expected=want)
        rec["first_minibatch_ok"] = len(firsts) == 2 and all(
            abs(m["importance_weight"] - 1) <= lim["importance_weight"]
            and abs(m["ppo_approx_kl"]) <= lim["ppo_approx_kl"]
            for m in firsts)
        rec["ok"] = bool(
            rec["mfc_runs"] == dict.fromkeys(PPO_MFCS, 2)
            and len(runner.step_stats) == 2 and stats_finite
            and all(rec["rollout"][k] for k in (
                "tokens_in_range", "tokens_inside_mask", "logprobs_ok"))
            and rec["first_minibatch_ok"] and counts == want
            and all(v == dict(model=2, engine=2 * PPO_MINIBATCHES)
                    for v in rec["versions"].values()))
        rec["launches_ok"] = counts == want
        segs = seen["segs"]
        # the wrappers tie each engine into a reference cycle
        del runner, actor, per_mb, seen
        gc.collect()
        torch.cuda.empty_cache()

        # one step with ref and reward offloaded after their MFCs
        spec, _ = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=1,
                                 auto_offload=True)
        runner = InlineRunner(without_saves(spec))
        off_seen = watch_ppo_runner(runner)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        idle = {r: runner.models[r].engine for r in ("ref", "reward")}
        sums = {r: tree_checksum(e.params) for r, e in idle.items()}
        nbytes = sum(tree_bytes(e.params) for e in idle.values())
        reset_counts()
        runner.run()
        torch.cuda.synchronize()
        off_counts = read_counts()
        after = torch.cuda.memory_allocated()
        offloaded = {r: e.offloaded for r, e in idle.items()}
        host_sums_ok = all(tree_checksum(e.params) == sums[r]
                           for r, e in idle.items())
        for e in idle.values():
            e.ensure_on_device()
        back = torch.cuda.memory_allocated()
        off_want = expected_ppo_launches(
            PPO_LAYERS, PPO_MINIBATCHES,
            runner.models["actor"].engine.generate_stats)
        off = dict(
            offloaded=offloaded, offloaded_bytes=nbytes,
            allocated_before=before, allocated_after_step=after,
            allocated_after_reload=back, freed=before - after,
            step_secs=runner.step_secs[0],
            mfc_secs={k: v[0] for k, v in off_seen["mfc_secs"].items()},
            bits_kept_on_host=host_sums_ok,
            bits_kept_after_reload=all(
                tree_checksum(e.params) == sums[r]
                and all(t.is_cuda for t in _tree_leaves(e.params))
                for r, e in idle.items()),
            launches=off_counts, launches_expected=off_want)
        # the freed bytes are the two models' weights (the allocator
        # rounds each tensor up, so allow 1%)
        off["ok"] = bool(
            all(offloaded.values()) and host_sums_ok
            and off["bits_kept_after_reload"] and off_counts == off_want
            and abs((before - after) - nbytes) <= 0.01 * nbytes
            and abs(back - before) <= 0.01 * nbytes
            # the first runner is gone: only this one's models are held
            and abs(before - leftover - resident) <= 0.01 * resident
            and not runner.models["actor"].engine.offloaded)
        rec["auto_offload"] = off
        rec["ok"] = rec["ok"] and off["ok"]
        # hand the runner on as it was built
        del runner.host.execute
        for role in PPO_ROLES:
            for method in ("generate", "forward_values", "forward_logprobs",
                           "train_minibatches"):
                vars(runner.models[role].engine).pop(method, None)
    return runner, segs, rec


def phase_kernels_ppo(segs, max_new_tokens=128):
    """K1-K4 against their plain versions at the shapes the ppo path ran
    them at, from the segment matrices its packer made (``segs``, kept
    by ``watch_ppo_runner``): K1 on the prefill of 16 left-padded
    prompts, on the one ~6 k-token stream of 16 sequences that rew_inf,
    ref_inf and critic_inf each forward, and on the longest minibatch
    stream of the train MFCs (4 sequences); K2/K3 on that minibatch
    stream, with the planted fault; K4 at 16 streams over the cache of
    prompt length + ``max_new_tokens`` slots, half the new tokens
    written. Same limits as phase 3; all timed."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def on_card(seg):
        return torch.as_tensor(seg, dtype=torch.int32, device="cuda")

    def longest(kind):
        return on_card(max(segs[kind], key=lambda a: a.size))

    prefill, stream, mb = (on_card(segs["prefill"][0]), longest("inference"),
                           longest("minibatch"))
    fwd = [check_flash_fwd(name, seg.shape[0], seg.shape[1], 32, 32, 128,
                           seg, True, gen, timed=True)
           for name, seg in (("ppo_prefill", prefill),
                             ("ppo_inference_stream", stream),
                             ("ppo_minibatch", mb))]
    for rec, seg in zip(fwd, (prefill, stream, mb)):
        rec["segments"] = int(seg.max()) if seg.shape[0] == 1 else 1
    b, lp = prefill.shape
    spans = [(lp - int(n), lp + max_new_tokens // 2)
             for n in (prefill != 0).sum(-1)]
    fwd.append(check_flash_decode("ppo_decode", b, lp + max_new_tokens, 32,
                                  32, 128, spans, gen, timed=True))
    bwd = [check_flash_bwd("ppo_minibatch", mb.shape[0], mb.shape[1], 32, 32,
                           128, mb, True, gen, timed=True, plant_fault=True)]
    bwd[0]["segments"] = int(mb.max())
    del gen
    torch.cuda.empty_cache()
    return fwd, bwd


PPO_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode")


def phase_ppo_profile(runner, smi):
    """One more ppo step (on the ``auto_offload`` runner), each MFC under
    its own torch.profiler trace: device time by kernel class (K1-K4,
    GEMMs, the rest), the device-busy share, and the optimizer steps'
    device time (CUDA events around each, inside the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    host = runner.host
    orig_execute = host.execute
    per_mfc = {}
    cuda = torch.autograd.DeviceType.CUDA

    def execute(name, inp):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            out = orig_execute(name, inp)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        by_cat = {}
        for e in prof.key_averages():
            if e.device_type == cuda:
                cat = kernel_category(e.key, PPO_KERNELS)
                by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total
        per_mfc[name] = dict(wall_ms=wall * 1e3, us_by_class=by_cat)
        return out

    events = {}
    for role in ("actor", "critic"):
        opt = runner.models[role].engine.optimizer
        events[role] = []

        def timed(params, grads, opt=opt, evs=events[role]):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            type(opt).step(opt, params, grads)
            ev[1].record()
            evs.append(ev)

        opt.step = timed
    host.execute = execute
    try:
        runner.run_step(next(iter(runner.dataloader)))
        torch.cuda.synchronize()
    finally:
        del host.execute
        for role in events:
            del runner.models[role].engine.optimizer.step
    mfc_wall = sum(m["wall_ms"] for m in per_mfc.values())
    rec = dict(card=smi, mfc_wall_ms=mfc_wall, optimizer_step_ms={
        role: sum(a.elapsed_time(b) for a, b in evs)
        for role, evs in events.items()})
    if not any(m["us_by_class"] for m in per_mfc.values()):
        rec["device_time"] = "not measured (no device events in the trace)"
        return rec
    total = {}
    for name, m in per_mfc.items():
        us = m.pop("us_by_class")
        kernel_us = sum(us.values())
        m.update(kernel_ms=kernel_us / 1e3,
                 busy_share=kernel_us / 1e3 / m["wall_ms"],
                 ms_by_class={k: v / 1e3 for k, v in us.items()})
        for k, v in us.items():
            total[k] = total.get(k, 0.0) + v
    all_us = sum(total.values())
    rec.update(by_mfc=per_mfc, kernel_ms=all_us / 1e3,
               busy_share=all_us / 1e3 / mfc_wall,
               ms_by_class={k: v / 1e3 for k, v in total.items()},
               share_by_class={k: v / all_us for k, v in total.items()},
               optimizer_share=sum(rec["optimizer_step_ms"].values()) * 1e3
               / all_us)
    return rec


# one greedy rollout through the inference MFCs: card (bf16, the
# kernels) against the CPU (fp32, the plain versions); then the train
# MFCs' first minibatch: card bf16 with the kernels against a plain fp32
# reference of the same step on the card. The inference limits are each
# about 3x the sound reading (PERF.md, Findings). The four train limits
# (loss, grad norms) are about 3x the largest of ten readings (seeds
# 12-16, two builds of K1), each within 1.5x of what the card's bf16
# step with the plain attention read: bf16 rounding, not the kernels
# (PERF.md, Findings).
PPO_PARITY_LIMITS = dict(
    rewards_rel=0.025, values_rel=0.03, ref_logprobs_abs=0.05,
    ref_logprobs_mean_abs=0.012, actor_loss_abs=1.6e-3,
    actor_grad_norm_rel=5e-3, importance_weight_abs=3.5e-3,
    approx_kl_abs=3.5e-3, value_loss_rel=6e-3, critic_grad_norm_rel=8e-3)
PPO_PARITY_SEED = 12


def phase_ppo_parity(seed=PPO_PARITY_SEED):
    """At ``train_parity``'s reduced size (2 layers, hidden 1024, 8 heads
    of 128, FFN 2816, vocab 32000): one greedy rollout on the card, then
    the same ``SequenceSample`` through rew_inf, ref_inf, critic_inf on
    the card (bf16, kernels) and on the CPU (fp32, plain versions) from
    the same weights: rewards, values and reference log-probs within
    limits. Then, with the card's inference outputs merged in,
    actor_train and critic_train (2 minibatches, the optimizer state
    offloaded to the host between train calls on the card) from the same
    weights four ways: on the card in bf16 with the kernels (the port),
    on the card in bf16 with the plain attention patched in (what bf16
    rounding alone gives), on the card in fp32 with the plain attention
    (the reference) and on the CPU in fp32. The port's first-minibatch
    loss and grad norm must sit within limits of the reference; the
    other two are reported beside it. Planted faults: the generation
    log-probs shifted by one token must read an approximate KL over 10x
    its limit (its importance weight, a mean of ratios on either side of
    1, moves little and decides nothing), and the old values shifted by
    one token must read a value loss over 10x its limit from the
    reference's."""
    import numpy as np
    import torch
    from realhf_tpu_torch.api.config import ModelName
    from realhf_tpu_torch.api.data import SequenceSample
    from realhf_tpu_torch.api.model import Model
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces.ppo import (
        PPOActorInterface,
        PPOCriticInterface,
    )
    from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.convert import params_numpy
    from realhf_tpu_torch.ops.attention import packed_attention_plain
    nl = 2
    base = dict(llama_config("7b", n_layers=nl), hidden_dim=1024,
                n_q_heads=8, n_kv_heads=8, intermediate_dim=2816,
                gradient_checkpointing=True)
    tok = IntegerTokenizer(vocab_size=base["vocab_size"] - 2)
    opt = OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0, offload=True)
    critics = dict(actor=False, ref=False, critic=True, reward=True)
    # bf16 weights, the same numbers on both sides
    weights = {
        role: params_numpy(T.init_params(
            TransformerConfig(**base, is_critic=c, param_dtype="bfloat16",
                              compute_dtype="bfloat16"),
            seeding.generator(20 + i), "cpu"))
        for i, (role, c) in enumerate(critics.items())}

    def model(role, dev, dt):
        return Model(ModelName(role, 0), Engine(
            TransformerConfig(**base, is_critic=critics[role],
                              param_dtype=dt, compute_dtype=dt),
            weights[role], dev,
            optimizer=opt if role in ("actor", "critic") else None), tok)

    def models(dev, dt):
        return {role: model(role, dev, dt) for role in critics}

    gconfig = dict(max_new_tokens=32, min_new_tokens=8, greedy=True)
    actor_kw = dict(n_minibatches=2, gconfig=gconfig, value_norm=True,
                    early_stop_imp_ratio=5.0)
    critic_kw = dict(n_minibatches=2, value_norm=True)
    rng = np.random.default_rng(seed)
    plens = [int(x) for x in rng.integers(30, 121, size=8)]
    prompts = SequenceSample.from_default(
        plens, list(range(8)), dict(packed_prompts=rng.integers(
            2, base["vocab_size"], size=sum(plens)).astype(np.int32)))

    card = models("cuda", "bfloat16")
    reset = read_counts()
    batch = PPOActorInterface(**actor_kw).generate(card["actor"], prompts)

    def inference(ms):
        out = {}
        for role, itf, key in (
                ("reward", PairedRewardInterface(), "rewards"),
                ("ref", PPOActorInterface(**actor_kw), "packed_ref_logprobs"),
                ("critic", PPOCriticInterface(**critic_kw), "values")):
            keys = ["packed_input_ids"] + (
                ["packed_logits_mask"] if role == "ref" else [])
            out[key] = itf.inference(ms[role], batch.select(keys))
        return out

    def train(model, itf, sample):
        """The first minibatch's own stats of one train MFC."""
        per_mb = []
        orig = model.engine.train_minibatches

        def train_minibatches(*args, **kw):
            per_mb.extend(orig(*args, **kw))
            return per_mb

        model.engine.train_minibatches = train_minibatches
        try:
            itf.train_step(model, sample, n_mbs=1)
        finally:
            del model.engine.train_minibatches
        return per_mb[0]

    def train_both(ms):
        return dict(
            actor=train(ms["actor"], PPOActorInterface(**actor_kw), batch),
            critic=train(ms["critic"], PPOCriticInterface(**critic_kw),
                         batch))

    def shifted(key):
        """A copy of the batch with ``key`` moved one token later."""
        out = batch.select(list(batch.keys))  # its own data dict
        x = batch.data[key].copy()
        x[1:] = x[:-1]
        out.data[key] = x
        return out

    def plain_attention(run):
        attn, T.packed_attention = T.packed_attention, packed_attention_plain
        try:
            return run()
        finally:
            T.packed_attention = attn

    inf_card = inference(card)
    for smp in inf_card.values():
        batch.update_(smp)
    # the actor's planted fault first, with an early stop that skips its
    # updates
    fault = train(card["actor"], PPOActorInterface(**dict(
        actor_kw, early_stop_imp_ratio=0.0)), shifted("packed_logprobs"))
    fault_skipped = (fault["early_stop_skipped"] == 1.0
                     and card["actor"].engine.optimizer.count == 0)
    got = train_both(card)
    opt_offloaded = all(card[r].engine.optimizer.offloaded
                        for r in ("actor", "critic"))
    launched = {k: v - reset[k] for k, v in read_counts().items()}
    del card
    # the critic's planted fault on a critic of its own, from the same
    # weights
    critic = model("critic", "cuda", "bfloat16")
    critic_fault = train(critic, PPOCriticInterface(**critic_kw),
                         shifted("values"))
    del critic
    torch.cuda.empty_cache()

    def train_on_card(dt):
        ms = {r: model(r, "cuda", dt) for r in ("actor", "critic")}
        out = plain_attention(lambda: train_both(ms))
        del ms
        torch.cuda.empty_cache()
        return out

    plain_bf16 = train_on_card("bfloat16")
    ref_fp32 = (torch.get_float32_matmul_precision() == "highest"
                and not torch.backends.cuda.matmul.allow_tf32)
    ref = train_on_card("float32")

    cpu = models("cpu", "float32")
    inf_cpu = inference(cpu)
    cpu_train = train_both(cpu)
    del cpu
    lim = PPO_PARITY_LIMITS

    def rel_max(key):
        a, b = inf_card[key].data[key], inf_cpu[key].data[key]
        return float(np.abs(a - b).max() / np.abs(b).max())

    def train_errs(x):
        """One run's first-minibatch stats against the reference's."""
        def rel(role, k):
            return abs(x[role][k] - ref[role][k]) / abs(ref[role][k])
        return dict(
            actor_loss_abs=abs(x["actor"]["actor_loss"]
                               - ref["actor"]["actor_loss"]),
            actor_grad_norm_rel=rel("actor", "grad_norm"),
            value_loss_rel=rel("critic", "value_loss"),
            critic_grad_norm_rel=rel("critic", "grad_norm"))

    d_ref = np.abs(inf_card["packed_ref_logprobs"].data["packed_ref_logprobs"]
                   - inf_cpu["packed_ref_logprobs"]
                   .data["packed_ref_logprobs"])
    errs = dict(
        rewards_rel=rel_max("rewards"), values_rel=rel_max("values"),
        ref_logprobs_abs=float(d_ref.max()),
        ref_logprobs_mean_abs=float(d_ref.mean()),
        **train_errs(got),
        importance_weight_abs=max(
            abs(got["actor"]["importance_weight"] - 1),
            abs(ref["actor"]["importance_weight"] - 1)),
        approx_kl_abs=max(abs(got["actor"]["ppo_approx_kl"]),
                          abs(ref["actor"]["ppo_approx_kl"])))
    fault_errs = dict(
        importance_weight_abs=abs(fault["importance_weight"] - 1),
        approx_kl_abs=abs(fault["ppo_approx_kl"]),
        value_loss_rel=abs(critic_fault["value_loss"]
                           - ref["critic"]["value_loss"])
        / abs(ref["critic"]["value_loss"]))
    seqlens = [l[0] for l in batch.seqlens["packed_input_ids"]]
    rec = dict(layers=nl, hidden=base["hidden_dim"], seed=seed,
               prompts=plens, seqlens=seqlens, card=got, reference=ref,
               reference_is="card, fp32 weights/compute/optimizer, plain "
               "attention", reference_fp32_matmul=ref_fp32,
               errors=errs, limits=lim,
               plain_bf16_errors=train_errs(plain_bf16),
               cpu_fp32_errors=train_errs(cpu_train),
               planted_faults=["generation log-probs shifted by one token",
                               "old values shifted by one token"],
               planted_fault_errors=fault_errs,
               planted_fault_update_skipped=fault_skipped,
               optimizer_state_offloaded=opt_offloaded, launches=launched)
    rec["ok"] = bool(
        all(math.isfinite(v) and v <= lim[k] for k, v in errs.items())
        and fault_errs["approx_kl_abs"] > 10 * lim["approx_kl_abs"]
        and fault_errs["value_loss_rel"] > 10 * lim["value_loss_rel"]
        and fault_skipped and opt_offloaded and ref_fp32
        and all(launched[k] > 0 for k in PPO_KERNELS))
    return rec


# ----------------------------------------------------------------------
# ctx and ppo_ctx: context-parallel inference through the entry points
# ----------------------------------------------------------------------
# c4 against c1 on the same bf16 weights (K6 against K1 over 32 layers):
# log-probs of the stream's valid positions, and ppo_ctx's reference
# log-probs and rewards, each about 3x the sound reading; and c4's mean
# distance from a plain fp32 reference at most ``fp32_mean_ratio`` times
# c1's (PERF.md, Findings)
CTX_LIMITS = dict(logprobs_abs=0.6, logprobs_mean_abs=0.033,
                  fp32_mean_ratio=1.5, ref_logprobs_abs=0.22,
                  ref_logprobs_mean_abs=0.024, rewards_rel=0.035)
# timed forward calls per engine in phase ctx, after the counted one
CTX_TIMED_CALLS = 3


def reset_peaks(devs):
    import torch
    for d in dict.fromkeys(devs):
        torch.cuda.reset_peak_memory_stats(d)


def read_peaks(devs) -> dict:
    """``max_memory_allocated`` of every distinct member device, GiB."""
    import torch
    return {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30
            for d in dict.fromkeys(devs)}


def ctx_launches(n_layers, n_members):
    """K6 per context-parallel forward: one round launch per layer per
    round per member, one push per layer per round but the last per
    member; K1 none."""
    return dict(ring_round=n_layers * n_members * n_members,
                ring_push=n_layers * (n_members - 1) * n_members,
                flash_fwd=0)


def phase_ctx(smi):
    """``Engine.forward_logprobs`` of a 32-layer LLaMA-7B (random bf16
    weights) over one packed stream of 32768 tokens (documents of 12288,
    7168, 6144, 4096 and 2816 tokens, then 256 of padding) on a c4
    layout over ``member_devices(4)``, then on c1 with the same weight
    tensors, where K1 runs over the whole stream. Each engine's first
    call is counted and checked; the seconds are the median of the
    ``CTX_TIMED_CALLS`` calls after it (host clock, every card
    synchronised), the peak memory that of every member device. Two bf16
    paths that round in other places drift apart over 32 layers; a plain fp32
    reference on the card (the same weights widened, ``forward_ctx`` with
    ``ring_attention_plain``) tells rounding from a fault: c4 must be no
    further from it than c1, within ``fp32_mean_ratio``."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.ops import functional as F
    from realhf_tpu_torch.ops.ring_attention import ring_attention_plain
    from realhf_tpu_torch.parallel.mesh import ParallelismConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = TransformerConfig(**llama_config("7b"), param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    params = T.init_params(cfg, gen, "cuda")
    devs = member_devices(CTX_MEMBERS)
    engines = dict(
        c4=Engine(cfg, params, "cuda:0", parallel=ParallelismConfig(
            context_parallel_size=CTX_MEMBERS), devices=devs),
        c1=Engine(cfg, params, "cuda:0"))
    seg = doc_stream_seg(CTX_DOCS, CTX_PAD, "cpu").numpy()
    ids = np.random.default_rng(5).integers(
        2, cfg.vocab_size, size=seg.shape).astype(np.int32)
    # positions whose next token continues the document
    valid = np.zeros(seg.shape, bool)
    valid[:, :-1] = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    runs, lps = {}, {}
    for tag, eng in engines.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_peaks(devs)
        # the first call is the path whose launches are counted and whose
        # output is checked; it also warms the engine up; then
        # CTX_TIMED_CALLS timed calls, their median and spread reported
        reset_counts()
        sync_all()
        lp = eng.forward_logprobs(ids, seg)
        sync_all()
        counts = read_counts()
        lps[tag] = lp.float().cpu().numpy()
        secs = []
        for _ in range(CTX_TIMED_CALLS):
            t0 = time.monotonic()
            eng.forward_logprobs(ids, seg)
            sync_all()
            secs.append(time.monotonic() - t0)
        med = float(np.median(secs))
        peaks = read_peaks(devs)
        runs[tag] = dict(secs=med, secs_all=secs,
                         secs_spread=(max(secs) - min(secs)) / med,
                         tokens_per_s=seg.size / med,
                         peak_mem_gb=max(peaks.values()),
                         peak_mem_gb_by_device=peaks,
                         launches=counts, shape=list(lp.shape))
    # the plain fp32 reference over the c4 members
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    plain_fp32 = (torch.get_float32_matmul_precision() == "highest"
                  and not torch.backends.cuda.matmul.allow_tf32)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = {d: _tree_map(lambda t, d=d: t.to(d, torch.float32), params)
           for d in dict.fromkeys(devs)}
    members = [p32[d] for d in devs]
    ids_t = torch.as_tensor(ids, device="cuda")
    seg_t = torch.as_tensor(seg, device="cuda")
    labels, lvalid = F.next_token_labels(ids_t, seg_t)
    t0 = time.monotonic()
    with torch.no_grad():
        hs = T.forward_ctx(
            cfg32, members, ring_shards(ids_t, devs), ring_shards(seg_t, devs),
            ring_shards(T.positions_from_segments(seg_t), devs),
            attention_fn=functools.partial(ring_attention_plain,
                                           block_q=1024, block_k=1024))
        lps["fp32"] = ring_gather([F.logprobs_from_hidden(
            cfg32, p, h, lab, val) for p, h, lab, val in zip(
                members, hs, ring_shards(labels, devs),
                ring_shards(lvalid, devs))]).cpu().numpy()
    sync_all()
    ref_secs = time.monotonic() - t0
    del p32, members, hs
    gc.collect()
    torch.cuda.empty_cache()
    d = np.abs(lps["c4"] - lps["c1"])[valid]
    to_fp32 = {tag: np.abs(lps[tag] - lps["fp32"])[valid]
               for tag in ("c4", "c1")}
    want = ctx_launches(cfg.n_layers, CTX_MEMBERS)
    lim = CTX_LIMITS
    rec = dict(n_layers=cfg.n_layers, tokens=int(seg.size), docs=CTX_DOCS,
               pad=CTX_PAD, member_devices=[str(x) for x in devs], card=smi,
               runs=runs, logprobs_abs=float(d.max()),
               logprobs_mean_abs=float(d.mean()),
               logprob_mean=float(lps["c1"][valid].mean()),
               fp32_reference=dict(
                   secs=ref_secs, plain_fp32_matmul=plain_fp32,
                   **{f"{tag}_abs": float(x.max())
                      for tag, x in to_fp32.items()},
                   **{f"{tag}_mean_abs": float(x.mean())
                      for tag, x in to_fp32.items()}),
               limits={k: lim[k] for k in ("logprobs_abs",
                                            "logprobs_mean_abs",
                                            "fp32_mean_ratio")},
               launches_expected=dict(c4=want, c1=dict(
                   flash_fwd=cfg.n_layers, ring_round=0, ring_push=0)))
    # the c4 run's counts, for the kernels line
    rec["launches"] = runs["c4"]["launches"]
    c4, c1 = runs["c4"]["launches"], runs["c1"]["launches"]
    rec["launches_ok"] = (all(c4[k] == v for k, v in want.items())
                          and c1["flash_fwd"] == cfg.n_layers
                          and c1["ring_round"] == c1["ring_push"] == 0)
    rec["outputs_ok"] = bool(
        all(r["shape"] == list(seg.shape) for r in runs.values())
        and all(np.isfinite(x).all() and (x[~valid] == 0).all()
                and (x[valid] <= 0).all() for x in lps.values()))
    ref = rec["fp32_reference"]
    rec["ok"] = bool(rec["launches_ok"] and rec["outputs_ok"] and plain_fp32
                     and rec["logprobs_abs"] <= lim["logprobs_abs"]
                     and rec["logprobs_mean_abs"] <= lim["logprobs_mean_abs"]
                     and ref["c4_mean_abs"]
                     <= lim["fp32_mean_ratio"] * ref["c1_mean_abs"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_ppo_ctx(smi):
    """The ppo-7bw-l4 cell's configuration and traffic with ref and
    reward at ``context_parallel_size=4`` on ``member_devices(4)``: one
    step through ``PPOConfig.build()`` and ``InlineRunner``. ref_inf and
    rew_inf must launch K6 exactly (layers x 4 rounds x 4 members) and K1
    never; then the step's rollout batch goes through ref_inf and rew_inf
    of a c1 host built from the same seed, whose reference log-probs and
    rewards must agree."""
    import numpy as np
    import torch
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.system.inline import InlineRunner
    from realhf_tpu_torch.system.model_host import ModelHost
    gc.collect()
    torch.cuda.empty_cache()
    devs = member_devices(CTX_MEMBERS)
    # the first ring call of ref_inf (its layer 0), kept for K6's case at
    # this path's own shapes
    mfc, first_ring = [None], {}
    ring = T.ring_attention_fused

    def watched_ring(qs, ks, vs, segs, **kw):
        if mfc[0] == "ref_inf" and not first_ring:
            first_ring.update(shards=[[t.detach().clone() for t in g]
                                      for g in (qs, ks, vs, segs)], kw=kw)
        return ring(qs, ks, vs, segs, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 160, seed=1)
        spec, _ = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=1,
                                 ctx=CTX_MEMBERS)
        runner = InlineRunner(without_saves(spec),
                              role_devices=dict(ref=devs, reward=devs))
        seen = watch_ppo_runner(runner)
        host = runner.host
        timed_execute = host.execute
        per_mfc = {}

        def counted(name, inp):
            before = read_counts()
            mfc[0] = name
            out = timed_execute(name, inp)
            mfc[0] = None
            per_mfc[name] = {k: v - before[k]
                             for k, v in read_counts().items()}
            return out

        host.execute = counted
        T.ring_attention_fused = watched_ring
        try:
            reset_peaks(devs)
            reset_counts()
            runner.run()
            sync_all()
            counts = read_counts()
        finally:
            T.ring_attention_fused = ring
        peaks = read_peaks(devs)
        batch = runner.last_batch
        gen_stats = runner.models["actor"].engine.generate_stats
        want_ring = ctx_launches(PPO_LAYERS, CTX_MEMBERS)
        want = expected_ppo_launches(PPO_LAYERS, PPO_MINIBATCHES, gen_stats)
        want["flash_fwd"] -= 2 * PPO_LAYERS   # ref_inf and rew_inf: K6
        want["ring_round"] = 2 * want_ring["ring_round"]
        want["ring_push"] = 2 * want_ring["ring_push"]
        mfc_ok = all(per_mfc[m][k] == v for m in ("ref_inf", "rew_inf")
                     for k, v in want_ring.items())
        step = ppo_step_records(runner, seen["mfc_secs"], smi)[0]
        inf_tokens = batch.total_len("packed_input_ids")
        del host.execute
        for role in PPO_ROLES:
            for method in ("generate", "forward_values", "forward_logprobs",
                           "train_minibatches"):
                vars(runner.models[role].engine).pop(method, None)
        del seen, timed_execute, host
        runner_ref = {k: batch.data[k].copy()
                      for k in ("packed_ref_logprobs", "rewards")}
        # the same batch through a c1 host built from the same seed
        spec1, _ = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=1)
        host1 = ModelHost(spec1, ["ref", "reward"],
                          [n for n in runner.dfg.nodes
                           if n.name in ("ref_inf", "rew_inf")],
                          spec1.tokenizer)
        reset_counts()
        c1 = {}
        for name, key in (("ref_inf", "packed_ref_logprobs"),
                          ("rew_inf", "rewards")):
            node = host1.nodes[name]
            inp = batch.select([k for k in node.input_keys
                                if k in batch.keys])
            c1[key] = host1.execute(name, inp).data[key]
        c1_counts = read_counts()
        del host1, runner
        gc.collect()
        torch.cuda.empty_cache()
    d = np.abs(runner_ref["packed_ref_logprobs"] - c1["packed_ref_logprobs"])
    rewards_rel = float(np.abs(runner_ref["rewards"] - c1["rewards"]).max()
                        / np.abs(c1["rewards"]).max())
    lim = CTX_LIMITS
    rec = dict(n_layers=PPO_LAYERS, member_devices=[str(x) for x in devs],
               card=smi, step=step, peak_mem_gb=max(peaks.values()),
               peak_mem_gb_by_device=peaks, ref_rew_tokens=int(inf_tokens),
               ref_rew_tokens_per_s={
                   m: inf_tokens / step["mfc_secs"][m]
                   for m in ("ref_inf", "rew_inf")},
               launches=counts, launches_expected=want,
               launches_by_mfc=per_mfc, c1_launches=c1_counts,
               ref_logprobs_abs=float(d.max()),
               ref_logprobs_mean_abs=float(d.mean()),
               rewards_rel=rewards_rel,
               limits={k: lim[k] for k in ("ref_logprobs_abs",
                                            "ref_logprobs_mean_abs",
                                            "rewards_rel")})
    rec["launches_ok"] = bool(counts == want and mfc_ok
                              and c1_counts["flash_fwd"] == 2 * PPO_LAYERS
                              and c1_counts["ring_round"] == 0)
    rec["ok"] = bool(
        rec["launches_ok"] and len(runner_ref["rewards"]) == len(c1["rewards"])
        and np.isfinite(runner_ref["rewards"]).all()
        and all(rec[k] <= v for k, v in rec["limits"].items()))
    return rec, first_ring


def check_ring_ppo_ctx(first_ring):
    """K6 against its plain version on the q/k/v/seg shards of ref_inf's
    first ring call in phase ppo_ctx (the path's own stream: ragged KV
    halves at hd 128), timed like the ctx-7b-c4 case."""
    kw = first_ring["kw"]
    return compare_ring("ppo_ctx_ref_inf", *first_ring["shards"],
                        causal=kw["causal"], window=kw["sliding_window"],
                        scale=kw["scale"], timed=True)


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# phases 16-21: the other algorithms (rw, dpo, grpo, reinforce, agentic,
# profile) at LLaMA-7B width, 4 layers a role, bf16, gradient
# checkpointing on
# ----------------------------------------------------------------------
ALGO_LAYERS = 4
ALGO_MINIBATCHES = 4
# each about 3x the largest sound reading of five seeds on the card
# (``scripts/torch_algo_limits.py``; PERF.md, Findings): rw card-vs-CPU
# loss 4.3e-3 and grad norm 2.8e-3 relative (the swapped-pairs fault
# 0.047-0.84); dpo step 1 |loss - ln 2| 5.7e-6, |kl| 1.5e-4, |score|
# 1.2e-5 (the swapped-ref fault 60-106); grpo step 1 |grpo_kl| 1.6e-4
RW_PARITY_LIMITS = dict(loss_rel=1.3e-2, grad_norm_rel=8.5e-3)
DPO_STEP1_LIMITS = dict(loss_ln2=2e-5, kl=5e-4, score=4e-5)
GRPO_KL_LIMIT = 5e-4


def algo_launches(fwd=0, bwd=0, decode=0):
    """A full launch-count dict: K1 ``fwd``, K2 = K3 = ``bwd``, K4
    ``decode``, nothing else."""
    return dict(flash_fwd=fwd, flash_bwd_dq=bwd, flash_bwd_dkv=bwd,
                flash_decode=decode, flash_decode_stacked=0, ring_round=0,
                ring_push=0)


def seven_b_roles(spec, n_layers=ALGO_LAYERS):
    """Every role of ``spec`` at LLaMA-7B width and ``n_layers``, bf16,
    random weights from the seed; the integer tokenizer. -> vocab."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.models.config import llama_config
    for mspec in spec.models.values():
        mspec.random_init_config = llama_config("7b", n_layers=n_layers)
        mspec.bf16 = True
    vocab = llama_config("7b")["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return vocab


def write_pairs(path, n, seed, lo=50, hi=200):
    """Prompts of 100-512 words, each with 2 (pos, neg) answer pairs of
    ``lo``-``hi`` words."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def words(a, b):
        return " ".join(f"w{int(w)}" for w in rng.integers(
            0, 5000, size=int(rng.integers(a, b + 1))))

    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps(dict(
                id=i, prompt=words(100, 512),
                pos_answers=[" " + words(lo, hi) for _ in range(2)],
                neg_answers=[" " + words(lo, hi) for _ in range(2)])) + "\n")


def watch_runner(runner) -> dict:
    """Wrap, on this runner's objects, what the script reads and the
    library does not keep: each MFC's host-clock seconds (up to a device
    synchronisation) and its output, and every minibatch's stats of each
    trained role's engine."""
    import torch
    from realhf_tpu_torch.api.config import ModelInterfaceType
    host = runner.host
    seen = dict(mfc_secs={name: [] for name in host.nodes},
                outputs={name: [] for name in host.nodes},
                minibatch_stats={})
    execute = host.execute

    def timed_execute(name, inp):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = execute(name, inp)
        torch.cuda.synchronize()
        seen["mfc_secs"][name].append(time.monotonic() - t0)
        seen["outputs"][name].append(out)
        return out

    host.execute = timed_execute
    for node in host.nodes.values():
        if node.interface_type != ModelInterfaceType.TRAIN_STEP:
            continue
        engine = runner.models[node.role].engine
        seen["minibatch_stats"][node.role] = got = []

        def train_minibatches(*args, _orig=engine.train_minibatches,
                              _got=got, **kw):
            _got.append(_orig(*args, **kw))
            return _got[-1]

        engine.train_minibatches = train_minibatches
    return seen


def unwatch(runner):
    vars(runner.host).pop("execute", None)
    for model in runner.models.values():
        vars(model.engine).pop("train_minibatches", None)


class no_update:
    """Train steps of ``model`` inside report their stats and change
    nothing: every loss asks the engine to skip its update
    (``__skip_update__``), and the versions are put back on exit.
    ``minibatch_stats`` keeps each call's per-minibatch stats."""

    def __init__(self, model):
        self.model, self.minibatch_stats = model, []

    def __enter__(self):
        import torch
        eng = self.model.engine
        self.versions = (eng.version, dataclasses.replace(self.model.version))
        orig = eng.train_minibatches

        def train_minibatches(minibatches, loss_fn, *args, **kw):
            def skip(params, mb):
                loss, stats = loss_fn(params, mb)
                return loss, dict(stats, __skip_update__=torch.ones_like(
                    loss.detach()))

            out = orig(minibatches, skip, *args, **kw)
            self.minibatch_stats.append(out)
            return out

        eng.train_minibatches = train_minibatches
        return self

    def __exit__(self, *exc):
        eng = self.model.engine
        del eng.train_minibatches
        eng.version, self.model.version = self.versions
        return False


def clone_params(src, dst):
    """``dst``'s engine takes a copy of ``src``'s weights (not the same
    tensors: the source's optimizer updates its own in place)."""
    dst.engine.set_params(_tree_map(lambda t: t.clone(), src.engine.params))


def probe_inputs(runner, batch):
    """Run every MFC but the train ones over ``batch``, in the graph's
    order, merging each output into it: the train MFCs' input of one
    step, outside any counted window."""
    from realhf_tpu_torch.api import data as data_api
    from realhf_tpu_torch.api.config import ModelInterfaceType
    for level in runner.dfg.topological_levels():
        for node in level:
            if node.interface_type == ModelInterfaceType.TRAIN_STEP:
                continue
            out = runner.host.execute(node.name, batch.select(
                [k for k in node.input_keys if k in batch.keys]))
            assert isinstance(out, data_api.SequenceSample)
            batch.update_(out)
    return batch


def shifted_logprobs(batch, node):
    """``node``'s input with the generation log-probs moved one token
    later (the fault of an off-by-one between decode and packed
    forward)."""
    inp = batch.select([k for k in node.input_keys if k in batch.keys])
    lp = inp.data["packed_logprobs"].copy()
    lp[1:] = lp[:-1]
    inp.data = dict(inp.data, packed_logprobs=lp)
    return inp


def algo_record(runner, seen, smi, counts, want, peak, setup):
    """What every algorithm phase reports: step and per-MFC seconds, the
    peak, launch counts against the expected ones, and whether every stat
    (the interface's and each minibatch's) is finite."""
    finite = all(math.isfinite(v) for step in runner.step_stats
                 for st in step.values() for v in st.values()) and all(
        math.isfinite(v) for calls in seen["minibatch_stats"].values()
        for call in calls for st in call for v in st.values())
    return dict(
        n_layers=ALGO_LAYERS, setup_secs=setup, card=smi,
        step_secs=runner.step_secs, mfc_secs=seen["mfc_secs"],
        mfc_runs={k: len(v) for k, v in seen["mfc_secs"].items()},
        peak_mem_gb=peak, stats=runner.step_stats, stats_finite=finite,
        launches=counts, launches_expected=want,
        launches_ok=counts == want)


def run_counted(runner):
    """``runner.run()`` between a count reset and a read, with the
    allocator's peak -> (counts, peak GB, generate calls' stats)."""
    import torch
    gen = [m.engine.generate_stats for m in runner.models.values()]
    before = [len(g) for g in gen]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    calls = [st for g, n in zip(gen, before) for st in g[n:]]
    return counts, peak, calls


def build_runner(spec):
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    runner = InlineRunner(without_saves(spec))  # device=None: the card
    torch.cuda.synchronize()
    return runner, time.monotonic() - t0


def drop_runner(runner):
    import torch
    unwatch(runner)
    del runner
    gc.collect()
    torch.cuda.empty_cache()


def rw_pairs_sample(rng, vocab, n_elems=4, lo=60, hi=160):
    """Elements of 2 interleaved (pos, neg) pairs of random tokens, and
    the same with every pair's pos and neg swapped."""
    import numpy as np
    from realhf_tpu_torch.api.data import SequenceSample
    seqs = [[rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1)))
             .astype(np.int32) for _ in range(4)] for _ in range(n_elems)]

    def sample(elems):
        return SequenceSample(
            keys=["packed_input_ids"],
            trailing_shapes=dict(packed_input_ids=()),
            dtypes=dict(packed_input_ids=np.int32),
            ids=list(range(n_elems)),
            seqlens=dict(packed_input_ids=[[len(s) for s in e]
                                           for e in elems]),
            data=dict(packed_input_ids=np.concatenate(
                [s for e in elems for s in e])))

    swapped = [[e[1], e[0], e[3], e[2]] for e in seqs]
    return sample(seqs), sample(swapped)


def rw_parity(seed=7):
    """One ``paired_rw`` train step on the card (bf16, the kernels) and on
    the CPU (fp32, the plain versions) from the same bf16 weights and
    batch, at ``train_parity``'s size (2 layers, hidden 1024, 8 heads of
    128, FFN 2816, vocab 32000): loss and grad norm within limits; the
    card's step on the batch with every pair's pos and neg swapped must
    miss the loss limit."""
    import numpy as np
    from realhf_tpu_torch.api.config import ModelName
    from realhf_tpu_torch.api.model import Model
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.convert import params_numpy
    base = dict(llama_config("7b", n_layers=2), hidden_dim=1024,
                n_q_heads=8, n_kv_heads=8, intermediate_dim=2816,
                gradient_checkpointing=True, is_critic=True)
    cfgs = {dev: TransformerConfig(**base, param_dtype=dt, compute_dtype=dt)
            for dev, dt in (("cuda", "bfloat16"), ("cpu", "float32"))}
    weights = params_numpy(T.init_params(cfgs["cuda"],
                                         seeding.generator(seed), "cpu"))
    sample, swapped = rw_pairs_sample(np.random.default_rng(seed + 1),
                                      base["vocab_size"])
    opt = OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)

    def step(dev, s):
        eng = Engine(cfgs[dev], weights, dev, optimizer=opt)
        return PairedRewardInterface().train_step(
            Model(ModelName("reward", 0), eng, None), s)

    out = {dev: step(dev, sample) for dev in ("cuda", "cpu")}
    fault = step("cuda", swapped)
    lim = RW_PARITY_LIMITS

    def rel(a, k):
        return abs(a[k] - out["cpu"][k]) / abs(out["cpu"][k])

    rec = dict(layers=2, hidden=base["hidden_dim"], seed=seed,
               tokens=int(sample.total_len("packed_input_ids")), stats=out,
               loss_rel_err=rel(out["cuda"], "loss"),
               grad_norm_rel_err=rel(out["cuda"], "grad_norm"), limits=lim,
               planted_fault="every pair's pos and neg swapped",
               planted_fault_stats=fault,
               planted_fault_loss_rel_err=rel(fault, "loss"))
    rec["ok"] = (rec["loss_rel_err"] <= lim["loss_rel"]
                 and rec["grad_norm_rel_err"] <= lim["grad_norm_rel"]
                 and rec["planted_fault_loss_rel_err"] > lim["loss_rel"])
    return rec


def phase_rw(smi):
    """The ``rw`` experiment through ``RWConfig.build()`` and
    ``InlineRunner``: 2 steps of 8 prompts x 2 (pos, neg) pairs, one
    microbatch; per step K1 = 2L (forward and checkpoint recompute),
    K2 = K3 = L. Then ``rw_parity``."""
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.rw_exp import RWConfig
    steps, L = 2, ALGO_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "pairs.jsonl")
        write_pairs(data, 80, seed=3)
        cfg = RWConfig(experiment_name="chip-smoke", trial_name="rw",
                       benchmark_steps=steps)
        apply_overrides(cfg, {"dataset.path": data,
                              "dataset.train_bs_n_seqs": "8",
                              "dataset.max_seqlen": "1024",
                              "model.optimizer.lr": "1e-5"})
        spec = cfg.build()
        seven_b_roles(spec)
        runner, setup = build_runner(spec)
        seen = watch_runner(runner)
        counts, peak, _ = run_counted(runner)
    want = algo_launches(fwd=2 * L * steps, bwd=L * steps)
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    rec["last_batch_tokens"] = runner.last_batch.total_len("packed_input_ids")
    rec["versions"] = dict(model=runner.models["default"].version.global_step,
                           engine=runner.models["default"].engine.version)
    drop_runner(runner)
    rec["parity"] = rw_parity()
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["mfc_runs"] == dict(trainDefault=steps)
                     and rec["versions"] == dict(model=steps, engine=steps)
                     and rec["parity"]["ok"])
    return rec


def phase_dpo(smi, seed=1):
    """The ``dpo`` experiment through ``DPOConfig.build()`` and
    ``InlineRunner`` on phase rw's data, actor and ref: the script first
    copies the actor's weights into the ref (the library does not), so
    step 1's loss must be ln 2 and its KL and scores 0. Per step K1 = L
    (ref_inf) + 2L, K2 = K3 = L. Planted fault, before the counted run
    and without an update: the reference sums of each pair's pos and neg
    swapped must miss the loss limit by over 10x."""
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.dpo_exp import DPOConfig
    steps, L = 2, ALGO_LAYERS
    lim = DPO_STEP1_LIMITS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "pairs.jsonl")
        write_pairs(data, 80, seed=3)
        cfg = DPOConfig(experiment_name="chip-smoke", trial_name="dpo",
                        benchmark_steps=steps, seed=seed)
        apply_overrides(cfg, {"dataset.path": data,
                              "dataset.train_bs_n_seqs": "8",
                              "dataset.max_seqlen": "1024",
                              "actor.optimizer.lr": "1e-5"})
        spec = cfg.build()
        seven_b_roles(spec)
        runner, setup = build_runner(spec)
        actor = runner.models["actor"]
        clone_params(actor, runner.models["ref"])
        batch = probe_inputs(runner, next(iter(runner.dataloader)))
        node = runner.host.nodes["actor_train"]
        fault_in = batch.select(list(node.input_keys))
        pairs = fault_in.data["seqlogp"].reshape(-1, 2)
        fault_in.data = dict(fault_in.data, seqlogp=pairs[:, ::-1].ravel())
        with no_update(actor):
            fault = runner.interfaces["actor_train"].train_step(
                actor, fault_in)
        seen = watch_runner(runner)
        counts, peak, _ = run_counted(runner)
    want = algo_launches(fwd=3 * L * steps, bwd=L * steps)
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    st = runner.step_stats[0]["actor_train"]
    step1 = dict(loss_ln2=abs(st["loss"] - math.log(2)), kl=abs(st["kl"]),
                 score=max(abs(st["pos_score"]), abs(st["neg_score"])))
    rec.update(step1=step1, limits=lim,
               planted_fault="reference sums of pos and neg swapped",
               planted_fault_loss_ln2=abs(fault["loss"] - math.log(2)),
               versions=dict(model=actor.version.global_step,
                             engine=actor.engine.version))
    rec["step1_ok"] = all(step1[k] <= lim[k] for k in lim)
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["step1_ok"]
                     and rec["planted_fault_loss_ln2"] > 10 * lim["loss_ln2"]
                     and rec["mfc_runs"] == dict(ref_inf=steps,
                                                 actor_train=steps)
                     and rec["versions"] == dict(model=steps, engine=steps))
    drop_runner(runner)
    return rec


def phase_grpo(smi, seed=1):
    """The ``grpo`` experiment through ``GRPOConfig.build()`` and
    ``InlineRunner``, actor, ref and reward: 2 steps of 4 prompts
    (100-512 words) x group 4 = 16 decode streams, up to 128 new tokens
    (min 32) sampled at top-p 1, top-k 0, temperature 1 (no logits mask to
    replay), 4 minibatches. The script copies the actor's weights into
    the ref. Per step K1 = 3L + 2NL, K2 = K3 = NL, K4 = L x decode steps.
    Each step's first minibatch runs on the weights that generated: its
    importance weight within PPO's limit of 1, and on step 1 |grpo_kl|
    (ref = actor) within its limit. Planted fault, before the counted run
    and without an update: old log-probs shifted by one token."""
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.grpo_exp import GRPOConfig
    steps, L, N, g = 2, ALGO_LAYERS, ALGO_MINIBATCHES, 4
    lim = PPO_FIRST_MINIBATCH_LIMITS["importance_weight"]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 40, seed=4)
        cfg = GRPOConfig(experiment_name="chip-smoke", trial_name="grpo",
                         benchmark_steps=steps, seed=seed)
        apply_overrides(cfg, {"dataset.path": data,
                              "dataset.train_bs_n_seqs": "4",
                              "dataset.max_seqlen": "512",
                              "grpo.group_size": str(g),
                              "grpo.max_new_tokens": "128",
                              "grpo.min_new_tokens": "32",
                              "grpo.top_p": "1.0", "grpo.top_k": "0",
                              "grpo.ppo_n_minibatches": str(N),
                              "actor.optimizer.lr": "1e-5"})
        spec = cfg.build()
        seven_b_roles(spec)
        runner, setup = build_runner(spec)
        actor = runner.models["actor"]
        clone_params(actor, runner.models["ref"])
        batch = probe_inputs(runner, next(iter(runner.dataloader)))
        with no_update(actor) as probe:
            runner.interfaces["actor_train"].train_step(
                actor, shifted_logprobs(batch,
                                        runner.host.nodes["actor_train"]))
        seen = watch_runner(runner)
        counts, peak, gen = run_counted(runner)
    want = algo_launches(fwd=(3 * L + 2 * N * L) * steps,
                         bwd=N * L * steps,
                         decode=L * sum(st["decode_steps"] for st in gen))
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    firsts = [call[0] for call in seen["minibatch_stats"]["actor"]]
    fault_iw = probe.minibatch_stats[0][0]["importance_weight"]
    rollouts = seen["outputs"]["actor_gen"]
    rec.update(
        decode_steps=[st["decode_steps"] for st in gen],
        generated_tokens=[st["generated_tokens"] for st in gen],
        first_minibatch=dict(
            importance_weight=[m["importance_weight"] for m in firsts],
            grpo_kl=[m["grpo_kl"] for m in firsts],
            limits=dict(importance_weight=lim, grpo_kl=GRPO_KL_LIMIT)),
        nested_per_id=[sorted({len(x) for x in r.seqlens["packed_input_ids"]})
                       for r in rollouts],
        planted_fault="old log-probs shifted by one token",
        planted_fault_importance_weight=fault_iw)
    rec["first_minibatch_ok"] = len(firsts) == steps and all(
        abs(m["importance_weight"] - 1) <= lim for m in firsts) and abs(
        firsts[0]["grpo_kl"]) <= GRPO_KL_LIMIT
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["first_minibatch_ok"]
                     and abs(fault_iw - 1) > 10 * lim
                     and rec["nested_per_id"] == [[g]] * steps
                     and rec["mfc_runs"] == dict.fromkeys(
                         ("actor_gen", "rew_inf", "ref_inf", "actor_train"),
                         steps))
    drop_runner(runner)
    return rec


def phase_reinforce(smi):
    """``ReinforceInterface`` driven directly, as a user of the interface
    would, on models from ``build_model``: actor, reward and ref
    (``kl_coef`` 0.05): 2 rounds of 8 prompts (100-512 words), each a
    sampled decode (up to 128 new tokens, min 32, top-p 1, top-k 0) and
    its greedy twin, the reward and ref inference, and a train step of 4
    minibatches. Per round K1 = 2L (two prefills) + 2L (two inference
    MFCs) + 2NL, K2 = K3 = NL, K4 = L x (sampled + greedy decode steps).
    Checks: the greedy halves are bit-equal to a greedy
    ``PPOActorInterface.generate`` of the same prompts on the same
    weights (its launches are left out of the counts; the sampled halves
    must not be), and the train step's loss mask holds exactly the
    sampled halves' generated tokens (all halves' count must not)."""
    import numpy as np
    import torch
    from realhf_tpu_torch.api import data as data_api
    from realhf_tpu_torch.api.config import DatasetAbstraction
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces.ppo import PPOActorInterface
    from realhf_tpu_torch.interfaces.reinforce import ReinforceInterface
    from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
    from realhf_tpu_torch.models.config import llama_config
    from realhf_tpu_torch.system.model_host import build_model
    rounds, L, N = 2, ALGO_LAYERS, ALGO_MINIBATCHES
    size = llama_config("7b", n_layers=L)
    tok = IntegerTokenizer(vocab_size=size["vocab_size"] - 2)
    seeding.set_random_seed(1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    opt = OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)
    models = {role: build_model(role, ModelSpec(
        random_init_config=dict(size), is_critic=role == "reward",
        optimizer=opt if role == "actor" else None), tok, init_seed=1)
        for role in ("actor", "reward", "ref")}
    torch.cuda.synchronize()
    setup = time.monotonic() - t0
    actor = models["actor"]
    gconfig = dict(max_new_tokens=128, min_new_tokens=32, top_p=1.0,
                   top_k=0, force_no_logits_mask=True)
    itf = ReinforceInterface(n_minibatches=N, gconfig=gconfig, kl_coef=0.05)
    twin = PPOActorInterface(gconfig=dict(gconfig, greedy=True))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.jsonl")
        write_prompts(path, 8 * rounds, seed=5)
        dataset = data_api.make_dataset(DatasetAbstraction(
            "prompt", dict(max_length=512, dataset_path=path)), 1, 0, 1, tok)
    loader = data_api.PackedDataLoader(dataset, batch_size=8, seed=1)
    masks = []
    eng = actor.engine
    orig_train = eng.train_minibatches

    def train_minibatches(minibatches, *args, **kw):
        masks.append(sum(float(mb["loss_mask"].sum()) for mbs in minibatches
                         for mb in mbs))
        return orig_train(minibatches, *args, **kw)

    eng.train_minibatches = train_minibatches
    recs, want = [], algo_launches()
    excluded = algo_launches()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for batch in loader:
        torch.cuda.synchronize()
        t_round = time.monotonic()
        n_gen = len(eng.generate_stats)
        sample = itf.generate(actor, batch)
        gen = eng.generate_stats[n_gen:]
        before = read_counts()
        greedy = twin.generate(actor, batch)
        excluded = {k: excluded[k] + v - before[k]
                    for k, v in read_counts().items()}
        torch.cuda.synchronize()
        t_gen = time.monotonic() - t_round
        parts, twins = sample.unpack(), greedy.unpack()
        halves_equal, sampled_equal, all_gen, sampled_gen = [], [], 0, 0
        for part, g in zip(parts, twins):
            ls, lg = part.seqlens["packed_input_ids"][0]
            ids = part.data["packed_input_ids"]
            halves_equal.append(bool(np.array_equal(
                ids[ls:], g.data["packed_input_ids"])))
            sampled_equal.append(bool(ids[:ls].shape == ids[ls:].shape
                                      and np.array_equal(ids[:ls], ids[ls:])))
            pm = part.data["prompt_mask"]
            sampled_gen += int((~pm[:ls]).sum())
            all_gen += int((~pm).sum())
        sample.update_(PairedRewardInterface().inference(
            models["reward"], sample.select(["packed_input_ids"])))
        sample.update_(itf.inference(models["ref"], sample.select(
            ["packed_input_ids"])))
        stats = itf.train_step(actor, sample)
        torch.cuda.synchronize()
        want = {k: want[k] + v for k, v in algo_launches(
            fwd=4 * L + 2 * N * L, bwd=N * L,
            decode=L * sum(st["decode_steps"] for st in gen)).items()}
        recs.append(dict(
            round_secs=time.monotonic() - t_round, generate_secs=t_gen,
            decode_steps=[st["decode_steps"] for st in gen],
            greedy_halves_bit_equal=all(halves_equal),
            sampled_halves_bit_equal_to_greedy=all(sampled_equal),
            loss_mask_tokens=masks[-1], sampled_generated_tokens=sampled_gen,
            all_generated_tokens=all_gen, stats=stats, card=smi))
    counts = {k: v - excluded[k] for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng.train_minibatches
    rec = dict(n_layers=L, setup_secs=setup, card=smi, rounds=recs,
               peak_mem_gb=peak, launches=counts, launches_expected=want,
               launches_excluded_twin=excluded, launches_ok=counts == want,
               versions=dict(model=actor.version.global_step,
                             engine=actor.engine.version))
    rec["ok"] = bool(
        len(recs) == rounds and rec["launches_ok"]
        and all(r["greedy_halves_bit_equal"]
                and not r["sampled_halves_bit_equal_to_greedy"]
                and r["loss_mask_tokens"] == r["sampled_generated_tokens"]
                and r["all_generated_tokens"] != r["sampled_generated_tokens"]
                and all(math.isfinite(v) for v in r["stats"].values())
                for r in recs)
        and rec["versions"] == dict(model=rounds, engine=rounds * N))
    del models, actor, itf, twin
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_agentic(smi):
    """The ``agentic`` experiment through ``AgenticPPOConfig.build()`` and
    ``InlineRunner`` on ``tool_game`` (3 turns an episode) with
    turn-level credit, actor, critic and ref: 2 steps of 16 episodes
    (prompts of 128 tokens), 32 new tokens a turn (top-p 1, top-k 0), 4
    minibatches. Per step K1 = L x generate calls + 2L (ref_inf,
    critic_inf) + 2 x 2NL, K2 = K3 = 2NL, K4 = L x the decode steps of
    all calls. No episode dropped, each sequence's turn rewards sum to its
    episode's, each step's first minibatch's importance weight (the
    packed forward over the whole multi-turn context against the per-turn
    decode log-probs) within PPO's limit; planted fault, before the
    counted run and without an update: old log-probs shifted by one
    token."""
    import numpy as np
    from realhf_tpu_torch.experiments.agentic_exp import AgenticPPOConfig
    from realhf_tpu_torch.experiments.common import apply_overrides
    steps, L, N, turns = 2, ALGO_LAYERS, ALGO_MINIBATCHES, 3
    lim = PPO_FIRST_MINIBATCH_LIMITS["importance_weight"]
    cfg = AgenticPPOConfig(experiment_name="chip-smoke", trial_name="agentic",
                           benchmark_steps=steps)
    apply_overrides(cfg, {"dataset.train_bs_n_seqs": "16",
                          "agentic.n_prompts": "48", "agentic.env": "tool_game",
                          "agentic.dataset_type": "tool_game",
                          "agentic.max_turns": str(turns),
                          "ppo.max_new_tokens": "32",
                          "ppo.min_new_tokens": "32", "ppo.top_p": "1.0",
                          "ppo.top_k": "0",
                          "ppo.ppo_n_minibatches": str(N),
                          "actor.optimizer.lr": "1e-5",
                          "critic.optimizer.lr": "1e-5"})
    spec = cfg.build()
    vocab = seven_b_roles(spec)
    spec.dataset.args.update(vocab_size=vocab, prompt_len=128)
    runner, setup = build_runner(spec)
    actor = runner.models["actor"]
    batch = probe_inputs(runner, next(iter(runner.dataloader)))
    with no_update(actor) as probe:
        runner.interfaces["actor_train"].train_step(
            actor, shifted_logprobs(batch, runner.host.nodes["actor_train"]))
    seen = watch_runner(runner)
    counts, peak, gen = run_counted(runner)
    calls = len(gen)
    want = algo_launches(
        fwd=L * calls + (2 * L + 2 * 2 * N * L) * steps,
        bwd=2 * N * L * steps,
        decode=L * sum(st["decode_steps"] for st in gen))
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    firsts = [call[0] for call in seen["minibatch_stats"]["actor"]]
    fault_iw = probe.minibatch_stats[0][0]["importance_weight"]
    dense_ok, n_turns = True, []
    for out in seen["outputs"]["actor_gen"]:
        n_turns += out.metadata["n_turns"]
        off = 0
        for lens, r in zip(out.seqlens["dense_rewards"],
                           out.data["rewards"]):
            d = out.data["dense_rewards"][off:off + lens[0]]
            dense_ok &= bool(np.isclose(d.sum(), r, rtol=1e-6, atol=1e-6))
            off += lens[0]
    rec.update(
        generate_calls=calls, decode_steps=[st["decode_steps"] for st in gen],
        episodes=len(n_turns), turns=n_turns.count(turns),
        dense_rewards_sum_to_reward=dense_ok,
        task_reward=[s["actor_train"]["task_reward"]
                     for s in runner.step_stats],
        first_minibatch=dict(
            importance_weight=[m["importance_weight"] for m in firsts],
            limit=lim),
        planted_fault="old log-probs shifted by one token",
        planted_fault_importance_weight=fault_iw)
    rec["first_minibatch_ok"] = len(firsts) == steps and all(
        abs(m["importance_weight"] - 1) <= lim for m in firsts)
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["first_minibatch_ok"] and dense_ok
                     and abs(fault_iw - 1) > 10 * lim
                     and n_turns == [turns] * (16 * steps)
                     and calls == turns * steps
                     and rec["mfc_runs"] == dict.fromkeys(
                         ("actor_gen", "ref_inf", "critic_inf",
                          "actor_train", "critic_train"), steps))
    drop_runner(runner)
    return rec


def phase_profile_exp(smi):
    """The ``profile`` experiment through ``ProfileConfig(model_size=
    "7b").build()`` with every role's ``n_layers`` cut to 4: 16 random
    prompts of 100-512 tokens, up to 128 new tokens (min 32), PPO's
    sampling and 4 minibatches, 1 step: the six MFCs, PPO's launch
    formula, finite stats, per-MFC seconds through ``watch_ppo_runner``."""
    import torch
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.profile_exp import ProfileConfig
    L, N = ALGO_LAYERS, ALGO_MINIBATCHES
    cfg = ProfileConfig(experiment_name="chip-smoke", trial_name="profile",
                        model_size="7b", benchmark_steps=1)
    apply_overrides(cfg, {"n_prompts": "16", "prompt_len_min": "100",
                          "prompt_len_max": "512",
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "512",
                          "ppo.max_new_tokens": "128",
                          "ppo.min_new_tokens": "32",
                          "ppo.ppo_n_minibatches": str(N)})
    spec = cfg.build()
    for mspec in spec.models.values():
        mspec.random_init_config["n_layers"] = L
    runner, setup = build_runner(spec)
    seen = watch_ppo_runner(runner)
    counts, peak, gen = run_counted(runner)
    want = expected_ppo_launches(L, N, gen)
    firsts = [call[0] for call in seen["minibatch_stats"]["actor_train"]]
    finite = all(math.isfinite(v) for st in runner.step_stats[0].values()
                 for v in st.values())
    rec = dict(n_layers=L, setup_secs=setup, card=smi,
               step_secs=runner.step_secs,
               mfc_secs={k: v[0] for k, v in seen["mfc_secs"].items()
                         if v},
               mfc_runs={k: len(v) for k, v in seen["mfc_secs"].items()},
               decode_steps=[st["decode_steps"] for st in gen],
               peak_mem_gb=peak, stats=runner.step_stats,
               stats_finite=finite,
               importance_weight=[m["importance_weight"] for m in firsts],
               launches=counts, launches_expected=want,
               launches_ok=counts == want)
    rec["ok"] = bool(rec["launches_ok"] and finite
                     and rec["mfc_runs"] == dict.fromkeys(PPO_MFCS, 1))
    vars(runner.host).pop("execute", None)
    for model in runner.models.values():
        for method in ("generate", "forward_values", "forward_logprobs",
                       "train_minibatches"):
            vars(model.engine).pop(method, None)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return rec


ALGO_PHASES = (("rw", phase_rw), ("dpo", phase_dpo), ("grpo", phase_grpo),
               ("reinforce", phase_reinforce), ("agentic", phase_agentic),
               ("profile_exp", phase_profile_exp))


def run_algo_phases(smi):
    """Each algorithm phase in turn, its JSON line and a summary line
    (step seconds, per-MFC seconds, peak, the card) -> their records."""
    recs = {}
    for name, phase in ALGO_PHASES:
        rec = recs[name] = phase(smi)
        emit(name, **rec)
        summary = {k: rec[k] for k in ("step_secs", "mfc_secs", "rounds",
                                       "peak_mem_gb") if k in rec}
        if "rounds" in summary:
            summary["rounds"] = [{k: r[k] for k in (
                "round_secs", "generate_secs")} for r in rec["rounds"]]
        print(f"{name}-7bw-l{ALGO_LAYERS}: {json.dumps(summary)} ({smi})",
              flush=True)
    return recs


# ----------------------------------------------------------------------
# phases 22-23: checkpoint IO and resume
# ----------------------------------------------------------------------
CKPT_NEW_TOKENS = 32
CKPT_RESUME_LAYERS = 4
#: a sound resume is bit-equal (reads 0); the planted fault (fresh
#: moments) must move some parameter by at least ten times this share
#: of the step's largest update
CKPT_RESUME_LIMIT = 0.01


def without_saves(spec):
    """The runner saves its trained roles at the end of every ``run``.
    The phases before the checkpoint phases time their steps without
    those saves (~150 GB of writes at their sizes), as they did before
    the port could save: every train MFC's interface gets
    ``enable_save=False``. Returns the spec."""
    from realhf_tpu_torch.api.config import ModelInterfaceType
    for node in spec.mfcs:
        if node.interface_type == ModelInterfaceType.TRAIN_STEP:
            node.interface_impl.args["enable_save"] = False
    return spec


def ckpt_scratch(need_bytes: int) -> str:
    """A fresh directory under ``_ckpt_scratch/`` beside this script
    (gitignored), after checking that ``need_bytes`` fit on its disk."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_ckpt_scratch")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < need_bytes:
        raise RuntimeError(
            f"checkpoint phases need {need_bytes / 1e9:.1f} GB free under "
            f"{root}; the disk has {free / 1e9:.1f} GB")
    return tempfile.mkdtemp(dir=root)


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _proc_status_kb(key) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    raise KeyError(key)


class HostPeak:
    """Growth of this process's resident memory over a block, in GB: the
    kernel's high-water mark (``VmHWM``) after resetting it through
    ``/proc/self/clear_refs``, or, where that is refused, the largest
    ``VmRSS`` a sampling thread saw."""

    def __enter__(self):
        import threading
        self.base = _proc_status_kb("VmRSS")
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.method = "VmHWM"
        except OSError:
            self.method = "sampled VmRSS"
        self._peak, self._stop = self.base, threading.Event()
        if self.method != "VmHWM":
            def sample():
                while not self._stop.wait(0.005):
                    self._peak = max(self._peak, _proc_status_kb("VmRSS"))
            self._thread = threading.Thread(target=sample, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.method == "VmHWM":
            self._peak = _proc_status_kb("VmHWM")
        else:
            self._stop.set()
            self._thread.join()
        self.growth_gb = (self._peak - self.base) / 2 ** 20


def named_leaves(tree, prefix=""):
    """(dotted path, leaf) in sorted-key order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += named_leaves(tree[k], f"{prefix}{k}.")
        else:
            out.append((prefix + k, tree[k]))
    return out


def leaves_equal(a, b) -> dict:
    """Per-leaf ``torch.equal`` of two trees -> {"all": bool, "differ":
    [paths]}. A numpy leaf of ``a`` is compared on its counterpart's
    device."""
    import torch
    from realhf_tpu_torch.base.safetensors_io import numpy_to_tensor
    la, lb = named_leaves(a), named_leaves(b)
    differ = [n for (n, x), (m, y) in zip(la, lb)
              if n != m or not torch.equal(
                  x if torch.is_tensor(x)
                  else numpy_to_tensor(x).to(y.device), y)]
    if len(la) != len(lb):
        differ.append("leaf count")
    return {"all": not differ, "differ": differ}


def skip_q_transpose():
    """Planted fault: the llama converter left q_proj in HF's (out, in)
    layout (square at 7B width, so the load goes through). Returns the
    function that restores it."""
    import numpy as np
    from realhf_tpu_torch.models import hf
    fam = hf.HF_FAMILIES["llama"]
    orig = fam.params_from_hf

    def faulty(state, cfg):
        params = orig(state, cfg)
        wq = params["blocks"]["attn"]["wq"]
        params["blocks"]["attn"]["wq"] = np.ascontiguousarray(
            wq.transpose(0, 2, 1))
        return params

    fam.params_from_hf = faulty

    def restore():
        fam.params_from_hf = orig
    return restore


def gen_tokens(runner):
    import numpy as np
    return np.array(runner.last_batch.data["packed_input_ids"])


def phase_ckpt_gen(smi):
    """The gen cell's 32-layer 7B model saved with the streamed save and
    loaded into a new gen runner (``model.path``, the streamed load):
    every leaf bit-equal to the saved model's and to the registry's eager
    load of the same files, a greedy batch's tokens equal to the original
    model's with exact K1/K4 counts; a loader that skips q_proj's
    transpose must fail both the leaves and the tokens."""
    import numpy as np
    import shutil
    import torch
    from realhf_tpu_torch.models import hf
    from realhf_tpu_torch.system.inline import InlineRunner
    n_layers = 32
    rec = dict(n_layers=n_layers, new_tokens=CKPT_NEW_TOKENS, card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=1)
        spec, vocab = build_gen_spec(data, n_layers, CKPT_NEW_TOKENS, 1)
        runner = InlineRunner(spec)  # device=None: the card
        eng = runner.models["default"].engine
        runner.run()
        want_tokens = gen_tokens(runner)
        model_bytes = tree_bytes(eng.params)
        ckpt = ckpt_scratch(int(model_bytes * 1.05) + 2 ** 30)
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            hf.save_hf_checkpoint_streamed(ckpt, "llama", eng.cfg,
                                           eng.params)
            save_s = time.monotonic() - t0
            written = dir_bytes(ckpt)
            rec.update(bytes_written=written, save_secs=save_s,
                       save_gb_per_s=written / save_s / 1e9)

            def load(compare_eager=False):
                lspec, _ = build_gen_spec(data, n_layers, CKPT_NEW_TOKENS, 1)
                apply_path(lspec, ckpt)
                gc.collect()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                with HostPeak() as host:
                    t0 = time.monotonic()
                    lrunner = InlineRunner(lspec)
                    torch.cuda.synchronize()
                    secs = time.monotonic() - t0
                leng = lrunner.models["default"].engine
                out = dict(secs=secs, gb_per_s=written / secs / 1e9,
                           host_peak_growth_gb=host.growth_gb,
                           host_peak_method=host.method,
                           device_peak_growth_gb=(
                               torch.cuda.max_memory_allocated() - base)
                           / 2 ** 30,
                           leaves=leaves_equal(leng.params, eng.params))
                if compare_eager:
                    # the registry's eager load: every file read whole
                    # into host numpy, then converted
                    with HostPeak() as host:
                        t0 = time.monotonic()
                        _, eager = hf.load_hf_checkpoint(ckpt)
                        eager_s = time.monotonic() - t0
                    out["registry_eager"] = dict(
                        secs=eager_s, gb_per_s=written / eager_s / 1e9,
                        host_peak_growth_gb=host.growth_gb,
                        host_peak_method=host.method,
                        leaves=leaves_equal(eager, leng.params))
                    del eager
                    gc.collect()
                reset_counts()
                lrunner.run()
                torch.cuda.synchronize()
                counts = read_counts()
                n_decode = sum(st["decode_steps"]
                               for st in leng.generate_stats)
                want = dict(flash_fwd=n_layers, flash_bwd_dq=0,
                            flash_bwd_dkv=0, flash_decode=n_layers * n_decode,
                            flash_decode_stacked=0, ring_round=0,
                            ring_push=0)
                out.update(tokens_equal=bool(np.array_equal(
                    gen_tokens(lrunner), want_tokens)),
                    decode_steps=n_decode, launches=counts,
                    launches_expected=want, launches_ok=counts == want)
                del lrunner, leng
                gc.collect()
                torch.cuda.empty_cache()
                return out

            rec["streamed"] = load(compare_eager=True)
            restore = skip_q_transpose()
            try:
                fault = load()
            finally:
                restore()
            rec["fault_skip_q_transpose"] = dict(
                leaves_equal=fault["leaves"]["all"],
                differ=fault["leaves"]["differ"],
                tokens_equal=fault["tokens_equal"])
        finally:
            shutil.rmtree(ckpt)
        del runner, eng
        gc.collect()
        torch.cuda.empty_cache()
    # the launches of the sound load's generate call
    got = rec["streamed"]
    rec["launches"] = got["launches"]
    rec["load_ok"] = (got["leaves"]["all"] and got["tokens_equal"]
                      and got["launches_ok"]
                      and got["registry_eager"]["leaves"]["all"])
    fault = rec["fault_skip_q_transpose"]
    rec["fault_caught"] = not fault["leaves_equal"] and not fault[
        "tokens_equal"]
    rec["ok"] = rec["load_ok"] and rec["fault_caught"]
    return rec


def apply_path(spec, path):
    """Point a built spec's default model at a checkpoint, as the
    ``model.path`` override does."""
    mspec = spec.models["default"]
    mspec.path, mspec.random_init_config = path, None


def build_resume_spec(data_path, trial, benchmark_steps, save_freq_steps=None):
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.sft_exp import SFTConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = SFTConfig(experiment_name="chip-smoke", trial_name=trial,
                    total_train_epochs=1, benchmark_steps=benchmark_steps,
                    save_freq_steps=save_freq_steps)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "1024", "n_mbs": "2",
                          "model.optimizer.lr": "1e-5"})
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.random_init_config = llama_config("7b",
                                            n_layers=CKPT_RESUME_LAYERS)
    spec.tokenizer = IntegerTokenizer(
        vocab_size=mspec.random_init_config["vocab_size"] - 2)
    return spec


def watch_steps(runner):
    """Record each step's batch ids on the runner's own ``run_step``."""
    seen, step = [], runner.run_step

    def watched(batch):
        out = step(batch)
        seen.append(list(batch.ids))
        return out

    runner.run_step = watched
    return seen


def param_snapshot(eng):
    return [(n, t.clone()) for n, t in named_leaves(eng.params)]


def update_diff(got, want, before) -> float:
    """The largest |got - want| over the largest |want - before|, over
    every parameter leaf (the step's update as the yardstick)."""
    num = max(float((g.float() - w.float()).abs().max())
              for (_, g), (_, w) in zip(got, want))
    den = max(float((w.float() - b.float()).abs().max())
              for (_, w), (_, b) in zip(want, before))
    return num / den


def phase_ckpt_resume(smi):
    """The sft cell at 7B width, 4 layers, lr 1e-5, gradient checkpointing,
    3 steps of 16 records: run A takes 3 steps; run B takes 2 with
    ``save_freq_steps=1`` and ``recover_mode="auto"``; run C, a new runner
    with ``recover_mode="resume"``, takes step 3 from B's last save. C's
    batch, loss, grad norm and updated weights must equal A's step 3, with
    exact K1/K2/K3 counts. Planted fault D: C with its optimizer state
    left fresh must move the weights away from A's by >= 10x the limit."""
    import shutil
    import torch
    from realhf_tpu_torch.base import constants
    from realhf_tpu_torch.engine import opt_checkpoint
    from realhf_tpu_torch.system import model_host
    from realhf_tpu_torch.system.inline import InlineRunner
    L, mbs = CKPT_RESUME_LAYERS, 2
    rec = dict(n_layers=L, card=smi)
    tmp = tempfile.mkdtemp()
    data = os.path.join(tmp, "sft.jsonl")
    write_prompt_answers(data, 48, seed=5)

    def runner_of(trial, steps, save_freq=None, mode="disabled",
                  saves=True):
        gc.collect()
        torch.cuda.empty_cache()
        spec = build_resume_spec(data, trial, steps, save_freq)
        if not saves:
            without_saves(spec)
        with HostPeak() as host:
            t0 = time.monotonic()
            r = InlineRunner(spec, recover_mode=mode)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
        return r, dict(setup_secs=secs, host_peak_growth_gb=host.growth_gb,
                       host_peak_method=host.method)

    # A: the uninterrupted reference (its final save is not the subject)
    a, _ = runner_of("ckpt-a", 3, saves=False)
    a_ids = watch_steps(a)
    a.run()
    a_stats = [st["trainDefault"] for st in a.step_stats]
    a_after = param_snapshot(a.models["default"].engine)
    eng = a.models["default"].engine
    need = (tree_bytes(eng.params)
            + sum(4 * math.prod(s) for s, _ in eng.opt_state_spec()))
    del a, eng
    root = ckpt_scratch(int(need * 1.1) + 2 ** 30)
    orig_root, constants.ROOT_DIR = constants.ROOT_DIR, root
    orig_save_opt = opt_checkpoint.save_opt_state_iter
    try:
        # B: two steps, saving each, with the recover dump
        b, rec["b_setup"] = runner_of("ckpt-b", 2, save_freq=1, mode="auto")
        itf = b.interfaces["trainDefault"]
        saves = dict(weights=[], optimizer=[])

        def timed(kind, fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                saves[kind].append(time.monotonic() - t0)
                return out
            return call

        itf.save = timed("weights", itf.save)
        opt_checkpoint.save_opt_state_iter = timed("optimizer",
                                                   orig_save_opt)
        b.run()
        opt_checkpoint.save_opt_state_iter = orig_save_opt
        b_stats = [st["trainDefault"] for st in b.step_stats]
        del b, itf
        ckpt = os.path.join(constants.run_save_path("chip-smoke", "ckpt-b"),
                            "default")
        opt_bytes = os.path.getsize(os.path.join(ckpt,
                                                 opt_checkpoint.FILENAME))
        rec.update(saves_secs=saves, bytes_saved=dir_bytes(ckpt),
                   optimizer_bytes=opt_bytes,
                   b_losses=[s["loss"] for s in b_stats])

        def resume(fresh_moments=False):
            restore = model_host.opt_checkpoint.restore_engine_opt_state
            if fresh_moments:
                model_host.opt_checkpoint.restore_engine_opt_state = (
                    lambda *args, **kw: False)
            try:
                c, setup = runner_of("ckpt-b", 3, mode="resume")
            finally:
                model_host.opt_checkpoint.restore_engine_opt_state = restore
            if fresh_moments:  # its final save and dump would replace B's
                c._maybe_save = lambda *args, **kw: None
            ceng = c.models["default"].engine
            before = param_snapshot(ceng)
            ids = watch_steps(c)
            reset_counts()
            t0 = time.monotonic()
            c.run()
            torch.cuda.synchronize()
            run_s = time.monotonic() - t0
            counts = read_counts()
            st = c.step_stats[0]["trainDefault"] if c.step_stats else {}
            want = a_stats[2]
            after = param_snapshot(ceng)
            out = dict(setup, run_secs=run_s, step_secs=c.step_secs,
                       batch_ids_equal=ids[:1] == a_ids[2:3],
                       loss=st.get("loss"), grad_norm=st.get("grad_norm"),
                       loss_equal=st.get("loss") == want["loss"],
                       grad_norm_equal=st.get("grad_norm")
                       == want["grad_norm"],
                       global_step=c.global_step, launches=counts,
                       weights_equal=all(
                           torch.equal(x, y)
                           for (_, x), (_, y) in zip(after, a_after)),
                       update_diff=update_diff(after, a_after, before))
            del c, ceng, before, after
            return out

        # the fault first: the sound run's final save rewrites B's save
        rec["fault_fresh_moments"] = resume(fresh_moments=True)
        rec["c"] = resume()
    finally:
        opt_checkpoint.save_opt_state_iter = orig_save_opt
        constants.ROOT_DIR = orig_root
        shutil.rmtree(root)
        shutil.rmtree(tmp)
        gc.collect()
        torch.cuda.empty_cache()
    c = rec["c"]
    n = L * mbs  # one step: layers x microbatches
    want = dict(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n,
                flash_decode=0, flash_decode_stacked=0, ring_round=0,
                ring_push=0)
    rec["launches"] = c["launches"]
    rec["launches_expected"] = want
    rec["launches_ok"] = c["launches"] == want
    rec["a_losses"] = [s["loss"] for s in a_stats]
    rec["limit"] = CKPT_RESUME_LIMIT
    rec["resume_ok"] = (c["batch_ids_equal"] and c["loss_equal"]
                        and c["grad_norm_equal"] and c["weights_equal"]
                        and c["update_diff"] <= CKPT_RESUME_LIMIT
                        and c["global_step"] == 3)
    d = rec["fault_fresh_moments"]
    rec["fault_caught"] = d["update_diff"] >= 10 * CKPT_RESUME_LIMIT
    rec["ok"] = rec["resume_ok"] and rec["launches_ok"] and rec[
        "fault_caught"]
    return rec


# ----------------------------------------------------------------------
def kernels_line(kernel_recs, bwd_recs, ring_recs, paths):
    """One row per kernel. ``launches`` sums the kernel's counts over the
    paths run (gen, deep, sft, the two ppo steps, ctx, ppo_ctx, rw, dpo,
    grpo, reinforce, agentic, profile_exp, ckpt_gen's load and
    ckpt_resume's resumed step), each counted from 0 just before its path
    and read just after it."""
    def timed(kernel):
        return next(r for r in kernel_recs
                    if r["kernel"] == kernel and "ms" in r)

    def errmax(kernel):
        return max(r["max_abs_err"] for r in kernel_recs
                   if r["kernel"] == kernel)

    launches = {k: sum(p["launches"][k] for p in paths)
                for k in paths[0]["launches"]}
    rows = [
        ("flash_fwd", "realhf_tpu_torch/csrc/flash_fwd.cu",
         "realhf_tpu/ops/flash_attention.py:55"),
        ("flash_decode", "realhf_tpu_torch/csrc/flash_decode.cu",
         "realhf_tpu/ops/decode_attention.py:114"),
        ("flash_decode_stacked", "realhf_tpu_torch/csrc/flash_decode.cu",
         "realhf_tpu/ops/decode_attention.py:135"),
    ]
    out = []
    for name, src, replaces in rows:
        t = timed(name)
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=launches[name],
                        max_abs_err=errmax(name), ms=t["ms"],
                        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                        bound_by=t["bound_by"], library_ms=t["library_ms"]))
    t = next(r for r in bwd_recs if "dq_ms" in r)
    for name, key, outs, replaces in (
            ("flash_bwd_dq", "dq", ("dq",),
             "realhf_tpu/ops/flash_attention.py:157"),
            ("flash_bwd_dkv", "dkv", ("dk", "dv"),
             "realhf_tpu/ops/flash_attention.py:195")):
        out.append(dict(
            name=name, route="cuda", source="realhf_tpu_torch/csrc/flash_bwd.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=max(r[f"{o}_max_abs_err"] for r in bwd_recs
                            for o in outs),
            ms=t[f"{key}_ms"], plain_ms=t["plain_ms"],
            bound_ms=t[f"{key}_bound_ms"], bound_by=t[f"{key}_bound_by"],
            library_ms=t["library_ms"]))
    for name, count in (("ring_attention", "ring_round"),
                        ("ring_push", "ring_push")):
        recs = [r for r in ring_recs if r["kernel"] == name]
        t = next(r for r in recs if "ms" in r)
        out.append(dict(
            name=name, route="cuda",
            source="realhf_tpu_torch/csrc/ring_attention.cu",
            replaces="realhf_tpu/ops/ring_attention_fused.py:103",
            launches=launches[count],
            max_abs_err=max(r["max_abs_err"] for r in recs), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    return {"kernels": out}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write every phase's record to this file")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "realhf_tpu_torch")):
        print("chip_smoke: realhf_tpu_torch is not beside this script.",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import realhf_tpu_torch  # noqa: F401
    from realhf_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.monotonic()
    built = _build.build()
    per_lib = {n: [ln.strip() for ln in _build.build_log.get(n, "")
                   .splitlines() if "registers" in ln or "spill" in ln
                   or "wgmma" in ln]
               for n in _build.SOURCES}
    emit("build", seconds=time.monotonic() - t0, per_library_secs=built,
         ptxas=per_lib)

    kernel_recs = phase_kernels()
    bwd_recs = phase_kernels_bwd()
    ring_recs = phase_kernels_ring()
    for r in kernel_recs + bwd_recs + ring_recs:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok = all(r["ok"] for r in kernel_recs + bwd_recs + ring_recs)
    main_rec = phase_gen(32, 128, smi, with_sampled_step=True)
    emit("main", **main_rec)
    deep_rec = phase_gen(49, 16, smi, with_sampled_step=False)
    emit("deep", **deep_rec)
    emit("profile", **phase_profile(smi))
    runner, sft_rec = phase_sft(smi)
    emit("sft", **sft_rec)
    for key in ("step_secs", "train_tokens_per_s", "peak_mem_gb"):
        print(f"sft-7bw-l8 {key}: {sft_rec[key]}", flush=True)
    emit("sft_profile", **phase_sft_profile(runner, smi))
    del runner
    torch.cuda.empty_cache()
    lr_rec = phase_sft_lr(smi)
    # the limit must tell the lr 1e-4 trajectory from the lr 1e-5 one
    lr_rec["lr_1e-5_rel_diff"] = max(
        abs(x - y) / abs(y)
        for x, y in zip(sft_rec["losses"], lr_rec["reference_losses"]))
    lr_rec["ok"] &= lr_rec["lr_1e-5_rel_diff"] > LR_WITNESS_LIMIT
    emit("sft_lr", **lr_rec)
    par = phase_parity()
    emit("parity", **par)
    train_par = phase_train_parity()
    emit("train_parity", **train_par)
    runner, ppo_segs, ppo_rec = phase_ppo(smi)
    emit("ppo", **ppo_rec)
    for st in ppo_rec["steps"]:
        print(f"ppo-7bw-l4 step {st['step']}: {json.dumps(st)}", flush=True)
    print(f"ppo-7bw-l4 peak_mem_gb: {ppo_rec['peak_mem_gb']} "
          f"(max_memory_allocated; {ppo_rec['leftover_gb']} of it left by "
          f"earlier phases; {smi})", flush=True)
    emit("ppo_profile", **phase_ppo_profile(runner, smi))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    ppo_fwd, ppo_bwd = phase_kernels_ppo(ppo_segs)
    for r in ppo_fwd + ppo_bwd:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    kernel_recs += ppo_fwd
    bwd_recs += ppo_bwd
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok &= all(r["ok"] for r in ppo_fwd + ppo_bwd)
    ppo_par = phase_ppo_parity()
    emit("ppo_parity", **ppo_par)
    ctx_rec = phase_ctx(smi)
    emit("ctx", **ctx_rec)
    for tag, run in ctx_rec["runs"].items():
        print(f"ctx-7b-c4 {tag}: {json.dumps(run)} ({smi})", flush=True)
    ppo_ctx_rec, first_ring = phase_ppo_ctx(smi)
    emit("ppo_ctx", **ppo_ctx_rec)
    ring_ppo = check_ring_ppo_ctx(first_ring)
    del first_ring
    torch.cuda.empty_cache()
    print(json.dumps(dict(phase="kernels", card=smi, **ring_ppo)), flush=True)
    ring_recs.append(ring_ppo)
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok &= ring_ppo["ok"]
    algo_recs = run_algo_phases(smi)
    ckpt_gen_rec = phase_ckpt_gen(smi)
    emit("ckpt_gen", **ckpt_gen_rec)
    load_rec = ckpt_gen_rec["streamed"]
    print("ckpt-gen-7b: " + json.dumps({
        k: ckpt_gen_rec[k] for k in ("bytes_written", "save_secs",
                                     "save_gb_per_s")} | {
        "streamed": {k: load_rec[k] for k in (
            "secs", "gb_per_s", "host_peak_growth_gb",
            "device_peak_growth_gb")},
        "registry_eager": {k: load_rec["registry_eager"][k] for k in (
            "secs", "gb_per_s", "host_peak_growth_gb")}})
        + f" ({smi})", flush=True)
    ckpt_resume_rec = phase_ckpt_resume(smi)
    emit("ckpt_resume", **ckpt_resume_rec)
    c = ckpt_resume_rec["c"]
    print(f"ckpt-resume-7bw-l{CKPT_RESUME_LAYERS}: " + json.dumps(dict(
        saves_secs=ckpt_resume_rec["saves_secs"],
        bytes_saved=ckpt_resume_rec["bytes_saved"],
        resume_setup_secs=c["setup_secs"],
        resume_host_peak_growth_gb=c["host_peak_growth_gb"],
        update_diff=c["update_diff"],
        fault_update_diff=ckpt_resume_rec["fault_fresh_moments"][
            "update_diff"])) + f" ({smi})", flush=True)
    ok &= (main_rec["ok"] and deep_rec["ok"] and par["ok"]
           and sft_rec["ok"] and lr_rec["ok"] and train_par["ok"]
           and ppo_rec["ok"] and ppo_par["ok"] and ctx_rec["ok"]
           and ppo_ctx_rec["ok"] and all(r["ok"] for r in algo_recs.values())
           and ckpt_gen_rec["ok"] and ckpt_resume_rec["ok"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if not ok:
        print("chip_smoke: a phase failed (see its JSON line).",
              file=sys.stderr)
        return 1
    print(json.dumps(kernels_line(
        kernel_recs, bwd_recs, ring_recs,
        [main_rec, deep_rec, sft_rec, ppo_rec, ctx_rec, ppo_ctx_rec]
        + list(algo_recs.values()) + [ckpt_gen_rec, ckpt_resume_rec])))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
