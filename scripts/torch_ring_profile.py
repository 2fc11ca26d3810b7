#!/usr/bin/env python3
"""Where the time of one ring-attention call (K6) goes, on the card.

    python3 scripts/torch_ring_profile.py [--out readings.json]

Two streams, each a ring of 4 members on ``chip_smoke.member_devices``
(all on cuda:0 on a one-card machine), 32/32 heads of 128, bf16 q/k/v
from a seed: the ctx-7b-c4 stream (``chip_smoke.CTX_DOCS``, 32768
tokens) and a stream of the ppo_ctx path's shape (16 sequences of
132-639 tokens packed longest first by the port's packer, padded to a
multiple of 32: 6400 tokens, shards of 1600). For each, one JSON line:

- ``ring_ms``: CUDA events around the call on the current stream, as
  ``chip_smoke.py`` times K6 (3 calls after 1);
- ``host_ms``: host clock of one call with no synchronisation (what
  Python takes to enqueue it), mean of 5;
- ``host_top``: the host functions that take that time, by own time
  over 5 calls under cProfile (which slows the host, so read the shares);
- from a torch.profiler trace of 3 calls, each between
  synchronisations: per call the device time of the round kernels, of
  the push kernels and of everything else (the slot copies), their
  union (device busy, kernels on the members' streams overlap), the
  wall from the host's start of the call to its last kernel's end, and
  the device idle share 1 - busy / wall.

Needs one CUDA card (about a minute on an H100).
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ppo_like_seg(seed=1):
    """[1, L] segment ids of 16 sequences packed as the ppo path packs
    its inference stream, padded to a multiple of 8 x 4 members."""
    import numpy as np
    import torch
    from realhf_tpu_torch.engine import packing
    rng = np.random.default_rng(seed)
    seqlens = [int(x) for x in rng.integers(132, 640, size=16)]
    info = packing.plan_packing(seqlens, 1, packing.DEFAULT_BUCKET)
    seg = packing.pad_stream_len(packing.segment_ids(info), 32)
    return torch.from_numpy(np.asarray(seg))


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_breakdown(path, n_calls):
    """Per call (the host's ``ring_call`` spans, in order): device time by
    class, busy union, wall and idle share, from a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "ring_call" and "dur" in e
                   and e.get("cat") == "user_annotation")
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "dur" in e]
    out = []
    for i, (h0, h1) in enumerate(calls[:n_calls]):
        nxt = calls[i + 1][0] if i + 1 < len(calls) else float("inf")
        mine = [k for k in kernels if h0 <= k[0] < nxt]
        by = {"round": 0.0, "push": 0.0, "other": 0.0}
        for s, e, name in mine:
            key = ("round" if "ring_round_kernel" in name else
                   "push" if "ring_push_kernel" in name else "other")
            by[key] += e - s
        busy = union_us([(s, e) for s, e, _ in mine])
        wall = max([e for _, e, _ in mine] + [h1]) - h0
        out.append(dict(host_span_ms=(h1 - h0) / 1e3,
                        round_kernels_ms=by["round"] / 1e3,
                        push_kernels_ms=by["push"] / 1e3,
                        other_device_ms=by["other"] / 1e3,
                        device_busy_ms=busy / 1e3, wall_ms=wall / 1e3,
                        device_idle_share=1 - busy / wall if wall else None,
                        kernels=len(mine)))
    return out


def host_profile(call, calls=5, top=10):
    """The functions with the most own host time over ``calls`` calls
    (each followed by a synchronisation outside the profile)."""
    import cProfile
    import pstats

    import chip_smoke
    prof = cProfile.Profile()
    for _ in range(calls):
        chip_smoke.sync_all()
        prof.enable()
        call()
        prof.disable()
    chip_smoke.sync_all()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [dict(function=f"{os.path.basename(f)}:{line}:{fn}",
                 calls=v[1] // calls, own_ms=v[2] / calls * 1e3,
                 share=v[2] / total)
            for (f, line, fn), v in rows]


def profile_stream(name, seg, gen):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    n = chip_smoke.CTX_MEMBERS
    devs = chip_smoke.member_devices(n)
    b, L = seg.shape
    seg = seg.to("cuda")
    q, k, v = (torch.randn((b, L, 32, 128), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    qs, ks, vs, segs = (chip_smoke.ring_shards(t, devs) for t in (q, k, v, seg))
    del q, k, v

    def call():
        return rf.ring_attention_fused(qs, ks, vs, segs)

    rec = dict(stream=name, tokens=L, lc=L // n,
               member_devices=[str(d) for d in devs])
    with torch.no_grad():
        rec["ring_ms"] = chip_smoke.cuda_ms(call, iters=3, warmup=1)
        host = []
        for _ in range(5):
            chip_smoke.sync_all()
            t0 = time.perf_counter()
            call()
            host.append(time.perf_counter() - t0)
            chip_smoke.sync_all()
        rec["host_ms"] = sum(host) / len(host) * 1e3
        rec["host_top"] = host_profile(call)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for _ in range(3):
                chip_smoke.sync_all()
                with record_function("ring_call"):
                    call()
                chip_smoke.sync_all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        calls = trace_breakdown(path, 3)
    if not calls or not any(c["kernels"] for c in calls):
        rec["profile"] = "not measured (no device events in the trace)"
    else:
        rec["profile"] = calls
    rec["walked_pairs"] = chip_smoke.ring_walked_pairs(
        seg, n, rf._plan_dirs(L // n, 512, True)[0], True)
    rec["allowed_pairs"] = chip_smoke.allowed_pairs(seg, True)
    del qs, ks, vs, segs
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the records here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    import chip_smoke
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    recs = []
    for name, seg in (
            ("ctx_7b_c4", chip_smoke.doc_stream_seg(
                chip_smoke.CTX_DOCS, chip_smoke.CTX_PAD, "cpu")),
            ("ppo_ctx_like", ppo_like_seg())):
        rec = profile_stream(name, seg, gen)
        rec["card"] = smi
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
