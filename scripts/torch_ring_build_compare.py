#!/usr/bin/env python3
"""K6 built from this checkout against K6 built from another source file
(another revision's ``ring_attention.cu``; one from before the lse output
is called without the lse pointer), on the card.

    python3 scripts/torch_ring_build_compare.py --other path/to/ring_attention.cu
                                                [--out readings.json]

Builds this checkout's ``realhf_tpu_torch/csrc/ring_attention.cu``
(through ``ops/_build``) and the other source with the same flags (the
other's ``attn_tile.cuh`` beside it), then runs each ring case of
``chip_smoke.phase_kernels_ring`` (the same shards of q, k, v and segment
ids, on ``member_devices(n)``; hd 64 and 128, which older builds take)
through both libraries. One JSON line per
case: whether the gathered outputs are bit-equal (``torch.equal``), their
largest difference, and the ms of one ring call of each (CUDA events over
3 calls after 1, in the order other, this, this, other; the two readings
of each averaged). Then the ptxas lines of both builds. Exits 1 when a
case differs. Needs one CUDA card and nvcc (about a minute on an H100).
"""

import argparse
import ctypes
import json
import os
import sys

from torch_k1_build_equal import build_other, ptxas_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the ring_attention.cu to hold this checkout's "
                         "against")
    ap.add_argument("--out", default=None,
                    help="also write every case's record here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    from realhf_tpu_torch.ops import _build
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    print(chip_smoke.nvidia_smi_line(), flush=True)
    this = _build.library("ring_attention")
    this_log = _build.build_log.get("ring_attention", "")
    other, other_log = build_other(args.other, "ring_attention")

    other_has_lse = "void* lse" in open(args.other).read()

    def use(lib):
        _build._libs["ring_attention"] = lib
        rf._fns.clear()
        if lib is other and not other_has_lse:
            # a source from before the lse output: its round entry takes
            # 12 pointers, this checkout's a 13th (null without the lse)
            fn = other.ring_round_bf16
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = ([p] * 12 + [i] * 12 + [ctypes.c_float] + [i] * 3
                           + [p])
            fn.restype = i

            def call(*a):
                if a[12] is not None:
                    raise ValueError(f"{args.other} writes no lse")
                return fn(*a[:12], *a[13:])
            rf._fns["ring_round_bf16"] = call

    # the ring cases of phase kernels, their shards made as check_ring
    # makes them; the push case is not run
    cases = []

    def capture(name, qs, ks, vs, segs, *, causal=True, window=None,
                scale=None, bidirectional=True, timed=False,
                plant_faults=False):
        cases.append((name, qs, ks, vs, segs, dict(
            causal=causal, sliding_window=window, scale=scale,
            bidirectional=bidirectional)))
        return dict(ok=True, kernel="ring_attention")

    chip_smoke.compare_ring = capture
    chip_smoke.check_ring_push = lambda *a, **kw: dict(ok=True)
    chip_smoke.phase_kernels_ring()

    records = []
    for name, qs, ks, vs, segs, kw in cases:
        def call():
            with torch.no_grad():
                return chip_smoke.ring_gather(
                    rf.ring_attention_fused(qs, ks, vs, segs, **kw))
        use(this)
        o = call()
        use(other)
        o_other = call()
        chip_smoke.sync_all()
        ms = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            use(this if tag == "this" else other)
            ms[tag].append(chip_smoke.cuda_ms(call, iters=3, warmup=1))
        rec = dict(case=name, shape=[*qs[0].shape, ks[0].shape[2]],
                   members=len(qs), **{k: v for k, v in kw.items()
                                       if k != "scale"},
                   o_equal=bool(torch.equal(o, o_other)),
                   o_max_abs_diff=chip_smoke.max_err(o, o_other),
                   ms_this=sum(ms["this"]) / 2,
                   ms_other=sum(ms["other"]) / 2, ms_all=ms)
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del o, o_other
        torch.cuda.empty_cache()
    use(this)
    ptxas = dict(this=ptxas_lines(this_log), other=ptxas_lines(other_log))
    print(json.dumps(dict(ptxas=ptxas)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(cases=records, ptxas=ptxas), f, indent=1)
    return 0 if all(r["o_equal"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
