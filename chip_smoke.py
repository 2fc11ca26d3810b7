#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``realhf_tpu_torch``) on one GPU.

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
   each stream dropped (K4), the backward with delta taken as 0 (K3).
   Then each kernel's time, the plain version's time, one PyTorch
   library call's time (``scaled_dot_product_attention`` with the same
   boolean mask, forward or backward, a yardstick only) and the least
   time the card could take (bound).
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

Then a ``{"kernels": [...]}`` line (launches summed over the gen, deep
and sft paths, each counted from 0), the ``nvidia-smi`` name/power line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

import argparse
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
              flash_bwd_dk_row_rel=0.07, flash_bwd_dv_row_rel=0.07)

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


def allowed_pairs(seg, causal) -> int:
    """(query, key) pairs the mask allows: the attention work this
    input needs."""
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    return int(segment_mask(seg, seg, causal).sum())


def check_flash_fwd(name, b, L, nq, nkv, hd, seg, causal, gen, timed):
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
        pairs = allowed_pairs(seg, causal)
        flops = 4.0 * hd * pairs * nq
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
    backward on the same bf16 values widened to fp32. With
    ``plant_fault``, the backward is also run with o = 0 (so delta = 0),
    which must exceed the dk limit."""
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
    rec["ok"] = all(
        rec[f"{key}_row_rel_err"] <= rec[f"{key}_row_rel_limit"]
        and rec[f"{key}_pad_rows_zero"] and rec[f"{key}_finite"]
        for key in ("dq", "dk", "dv"))
    if plant_fault:
        _, dk_bad, _ = fa.flash_attention_bwd(q, k, v, seg,
                                              torch.zeros_like(o), lse, do,
                                              causal=causal)
        rec["planted_fault"] = "delta taken as 0 (o = 0)"
        rec["planted_fault_dk_row_rel_err"] = row_rel_err(dk_bad, ref[1],
                                                          kv_rows, 0.01)
        rec["ok"] &= (rec["planted_fault_dk_row_rel_err"]
                      > LIMITS["flash_bwd_dk_row_rel"])
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
    fault), GQA 32/8 and 32/4, hd 64 (the "1b" shape), ragged L,
    non-causal, and an all-padding row."""
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
    del gen
    torch.cuda.empty_cache()
    return recs


def check_flash_decode(name, b, S, nq, nkv, hd, lengths, gen, timed,
                       stacked_layers=0, layer=0):
    import torch
    from realhf_tpu_torch.ops import decode_attention as da
    dev = "cuda"
    q = torch.randn((b, nq, hd), generator=gen, device=dev).bfloat16()
    nl = max(stacked_layers, 1)
    shape = (nl, b, nkv, S, hd)
    k_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
    valid = torch.zeros((b, S), dtype=torch.bool, device=dev)
    for i, (lo, hi) in enumerate(lengths):  # invalid low slots (left pad)
        valid[i, lo:hi] = True
    keep = da.window_keep(valid, None, None)

    def call(valid_mask, **kw):
        if stacked_layers:
            return da.flash_decode_attention_stacked(
                q, k_all, v_all, valid_mask, layer, **kw)
        return da.flash_decode_attention(q, k_all[0], v_all[0], valid_mask,
                                         **kw)

    out, m, l = call(valid, return_stats=True)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k_all[layer], v_all[layer], keep,
                                    return_stats=True)
    rows = valid.any(-1)[:, None].expand(b, nq)     # non-empty streams
    # planted fault: the newest valid slot of every stream dropped
    newest = S - 1 - valid.flip(-1).int().argmax(-1)
    dropped = valid.clone()
    dropped[torch.arange(b, device=dev)[rows[:, 0]], newest[rows[:, 0]]] = \
        False
    fault = row_rel_err(call(dropped), ref[0], rows)
    limit = LIMITS["flash_decode_row_rel"]
    rec = dict(kernel="flash_decode_stacked" if stacked_layers
               else "flash_decode", case=name, shape=[b, S, nq, nkv, hd],
               layer=layer, max_abs_err=max_err(out, ref[0]),
               row_rel_err=row_rel_err(out, ref[0], rows),
               row_rel_limit=limit, planted_fault_row_rel_err=fault,
               empty_rows_zero=bool((out.float()[~rows] == 0).all()),
               finite=bool(torch.isfinite(out.float()).all()))
    rec["m_max_abs_err"] = max_err(m, ref[1])
    rec["l_max_rel_err"] = float(((l - ref[2]).abs()
                                  / ref[2].abs().clamp_min(1e-6)).max())
    rec["ok"] = (rec["row_rel_err"] <= limit and fault > limit
                 and rec["empty_rows_zero"] and rec["finite"]
                 and rec["m_max_abs_err"] <= LIMITS["flash_decode_m"]
                 and rec["l_max_rel_err"] <= LIMITS["flash_decode_l_rel"])
    if timed:
        rec["ms"] = cuda_ms(lambda: call(valid))
        rec["plain_ms"] = cuda_ms(lambda: da.decode_attention_plain(
            q, k_all[layer], v_all[layer], keep), iters=5, warmup=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kl, vl, q4 = k_all[layer], v_all[layer], q[:, :, None, :]
        mask = valid[:, None, None, :]
        rec["library_ms"] = (cuda_ms(lambda: sdpa(q4, kl, vl, attn_mask=mask))
                             if nq == nkv else None)
        # K/V bytes of the kept slots only: the others are never needed
        kept = int(keep.sum())
        flops = 4.0 * hd * kept * nq
        nbytes = 2 * (q.numel() * 2 + 2 * kept * nkv * hd) + 4 * keep.numel()
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        rec["flops"], rec["bytes"] = flops, nbytes
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
                                True, gen, timed=True))
    # hd 64, causal and not
    seg = packed_seg(rng, 3, 256, 2, {1}, "cuda")
    for causal in (True, False):
        recs.append(check_flash_fwd(f"hd64_causal{int(causal)}", 3, 256, 16,
                                    4, 64, seg, causal, gen, timed=False))
    # K4 at the main path's decode shape: B 8, S 640, MHA; low slots of
    # each stream invalid (left padding), stream 5 empty
    spans = [(512 - n, 512 + 64) for n in lengths]
    spans[5] = (0, 0)
    recs.append(check_flash_decode("main_decode_mha", 8, 640, 32, 32, 128,
                                   spans, gen, timed=True))
    recs.append(check_flash_decode("gqa_32_4", 8, 640, 32, 4, 128, spans,
                                   gen, timed=False))
    recs.append(check_flash_decode("hd64_ragged_s", 4, 200, 8, 8, 64,
                                   [(10, 150), (0, 200), (0, 0), (199, 200)],
                                   gen, timed=False))
    # K5: a middle layer of a stacked cache, same per-layer shape as K4
    recs.append(check_flash_decode("stacked_mid_layer", 8, 640, 32, 32, 128,
                                   spans, gen, timed=True, stacked_layers=4,
                                   layer=2))
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
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    da.launches = 0
    da.stacked_launches = 0


def read_counts():
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                flash_bwd_dkv=fa.dkv_launches, flash_decode=da.launches,
                flash_decode_stacked=da.stacked_launches)


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
                     and counts["flash_bwd_dkv"] == 0)
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
        runner = InlineRunner(spec)  # device=None: the card
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
                flash_decode_stacked=0)
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


def kernel_category(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
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
        runner = InlineRunner(build_sft_spec(data, SFT_LAYERS, lr="1e-4"))
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


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


# ----------------------------------------------------------------------
def kernels_line(kernel_recs, bwd_recs, paths):
    """One row per kernel. ``launches`` sums the kernel's counts over the
    paths run (gen, deep and sft), each counted from 0 just before its
    path and read just after it."""
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
                   .splitlines() if "registers" in ln or "spill" in ln]
               for n in _build.SOURCES}
    emit("build", seconds=time.monotonic() - t0, per_library_secs=built,
         ptxas=per_lib)

    kernel_recs = phase_kernels()
    bwd_recs = phase_kernels_bwd()
    for r in kernel_recs + bwd_recs:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    RESULTS["kernels"] = kernel_recs + bwd_recs
    ok = all(r["ok"] for r in kernel_recs + bwd_recs)
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
    ok &= (main_rec["ok"] and deep_rec["ok"] and par["ok"]
           and sft_rec["ok"] and lr_rec["ok"] and train_par["ok"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if not ok:
        print("chip_smoke: a phase failed (see its JSON line).",
              file=sys.stderr)
        return 1
    print(json.dumps(kernels_line(kernel_recs, bwd_recs,
                                  [main_rec, deep_rec, sft_rec])))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
