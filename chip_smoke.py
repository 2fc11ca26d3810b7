#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``realhf_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, all run every time (each prints one JSON line; any failure
exits non-zero):

1. device  -- the card's name and power limit, PyTorch and CUDA versions.
2. build   -- compiles every CUDA kernel of the port from this checkout.
3. kernels -- each kernel against its plain PyTorch version on the card,
   in bf16, at the main path's shapes and at GQA / hd 64 / ragged /
   empty-row shapes: max abs error, and the largest error of an output
   row over that row's RMS beside its limit; a decode call with a
   planted fault (the newest slot of each stream dropped) must exceed
   that limit. Then the kernel's time,
   the plain version's time, one PyTorch library call's time
   (``scaled_dot_product_attention`` with the same boolean mask, a
   yardstick only) and the least time the card could take (bound).
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
7. profile -- a torch.profiler trace of one 7B generate call (8 prompts,
   16 new tokens): kernel time and device busy share of prefill and of
   a decode step, and the kernels by time. Reports, never fails.
8. parity  -- 7B width, 2 layers, 2 prompts: prefill and 8 greedy decode
   steps through the port on the card (kernels, bf16) and on the CPU
   (plain versions, fp32) from the same weights; logits must agree. The
   LM head on bf16 hidden states must return fp32 sums, not bf16-rounded
   ones.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

import argparse
import json
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
              flash_decode_l_rel=5e-6)

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


def row_rel_err(out, ref, rows) -> float:
    """Largest |out - ref| of an output row over the RMS of that row of
    ``ref``, over the rows where ``rows`` (out's shape less its last
    dim) is true. Rows averaging many values are small, so an absolute
    limit would let a dropped key through where they are."""
    d = (out.float() - ref.float()).abs().amax(-1)
    rms = ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-6)
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
# phases 4-7: the gen experiment through the port's entry points, and
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
    fa.launches = 0
    da.launches = 0
    da.stacked_launches = 0


def read_counts():
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    return dict(flash_fwd=fa.launches, flash_decode=da.launches,
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
                     and counts[other_key] == 0)
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
# phase 8: card against CPU
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


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


# ----------------------------------------------------------------------
def kernels_line(kernel_recs, main, deep):
    def timed(kernel):
        return next(r for r in kernel_recs
                    if r["kernel"] == kernel and "ms" in r)

    def errmax(kernel):
        return max(r["max_abs_err"] for r in kernel_recs
                   if r["kernel"] == kernel)

    launches = dict(main["launches"])
    launches["flash_decode_stacked"] = deep["launches"][
        "flash_decode_stacked"]
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
    for r in kernel_recs:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    RESULTS["kernels"] = kernel_recs
    ok = all(r["ok"] for r in kernel_recs)
    main_rec = phase_gen(32, 128, smi, with_sampled_step=True)
    emit("main", **main_rec)
    deep_rec = phase_gen(49, 16, smi, with_sampled_step=False)
    emit("deep", **deep_rec)
    emit("profile", **phase_profile(smi))
    par = phase_parity()
    emit("parity", **par)
    ok &= main_rec["ok"] and deep_rec["ok"] and par["ok"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if not ok:
        print("chip_smoke: a phase failed (see its JSON line).",
              file=sys.stderr)
        return 1
    print(json.dumps(kernels_line(kernel_recs, main_rec, deep_rec)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
