#!/usr/bin/env python3
"""``chip_smoke.py``'s context- and sequence-parallel training phases
alone, on the card.

    python3 scripts/torch_cp_phases.py [--out records.json]
        [--phases cp_sft sp_sft kernels cp_gemma kernels_hd256]
        [--seeds 1 2 3 4 5]

Builds the kernels, then runs the phases ``cp_sft``, ``sp_sft`` and
``cp_gemma`` (Gemma-2B at c2, c4 and d1t2c2: the ring at hd 256) (or
those ``--phases`` names), members on ``chip_smoke.member_devices``
(every member on cuda:0 with one card, spread over cuda:0..3 with four),
and ``kernels``: K2/K3 at ring rounds and K6's lse against their plain
versions (``chip_smoke.phase_kernels_cp``) at each cp_sft layout's shard
shape, on the stream that layout trained on, or, without cp_sft, on the
``CP_RECORDS`` packed in an order that puts a record across the first
shard boundary; and ``kernels_hd256``: K6, its lse and the ring's K2/K3
at hd 256 (``chip_smoke.phase_kernels_cp_hd256``) at each cp_gemma
layout's shard shape, on the stream that layout trained on, or on that
synthetic stream. Prints each record and "OK" when every check
passed. With ``--seeds``, ``cp_sft``, ``sp_sft`` and ``cp_gemma`` run
once per model seed instead and only the readings their limits
(``chip_smoke.CP_LIMITS``, ``PAR_LIMITS``, ``CP_GEMMA_LIMITS``) rest on
are printed, each sound reading beside its planted fault's.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("cp_sft", "sp_sft", "kernels", "cp_gemma", "kernels_hd256")
#: the cp_sft records in their file order, whose second record crosses
#: the first 4096-token shard boundary
SYNTHETIC_ORDER = (3584, 1536, 3000, 2616, 2824, 2824)


def readings(name, rec):
    """The numbers a phase's limits rest on."""
    keys = ("loss_rel", "grad_norm_rel", "update_rel", "logprobs_abs",
            "fault_logprobs_abs", "forward_abs", "fault_forward_abs",
            "step_secs_vs_ref", "peak_mem_vs_ref")
    return dict(layouts={lay: {k: r[k] for k in keys if k in r}
                         for lay, r in rec["layouts"].items()},
                fault=rec.get("planted_fault"))


def synthetic_segs():
    """The stream of ``SYNTHETIC_ORDER`` for every cp_sft and cp_gemma
    layout."""
    import chip_smoke
    import numpy as np
    seg = np.zeros((1, sum(SYNTHETIC_ORDER)), np.int32)
    off = 0
    for i, n in enumerate(SYNTHETIC_ORDER):
        seg[0, off:off + n] = i + 1
        off += n
    return {layout: [seg] for layout in (*chip_smoke.CP_LAYOUTS,
                                         *chip_smoke.CP_GEMMA_LAYOUTS)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="run cp_sft and sp_sft once per model seed for "
                         "readings")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    import chip_smoke
    from realhf_tpu_torch.ops import _build
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    _build.build()
    calls = dict(cp_sft=lambda s: chip_smoke.phase_cp_sft(smi, s),
                 sp_sft=lambda s: chip_smoke.phase_sp_sft(smi, s),
                 cp_gemma=lambda s: chip_smoke.phase_cp_gemma(smi, s))
    out, segs, gemma_segs, ok = {}, None, None, True
    for name in args.phases:
        if name.startswith("kernels"):
            continue
        for seed in (args.seeds or [1]):
            t0 = time.monotonic()
            rec = calls[name](seed)
            rec["phase_secs"] = time.monotonic() - t0
            if "_segs" in rec and name == "cp_gemma":
                gemma_segs = rec.pop("_segs")
            elif "_segs" in rec:
                segs = rec.pop("_segs")
            key = f"{name}.seed{seed}" if args.seeds else name
            out[key] = rec
            shown = readings(name, rec) if args.seeds else rec
            print(f"{key} ({rec['phase_secs']:.0f} s): "
                  + json.dumps(shown), flush=True)
            ok &= bool(rec["ok"]) or bool(args.seeds)
    if "kernels" in args.phases and not args.seeds:
        t0 = time.monotonic()
        bwd, lse = chip_smoke.phase_kernels_cp(segs or synthetic_segs())
        out["kernels"] = bwd + lse
        for r in bwd + lse:
            print(json.dumps(r), flush=True)
        print(f"kernels: {time.monotonic() - t0:.0f} s", flush=True)
        ok &= all(r["ok"] for r in bwd + lse)
    if "kernels_hd256" in args.phases and not args.seeds:
        t0 = time.monotonic()
        k6, bwd = chip_smoke.phase_kernels_cp_hd256(
            gemma_segs or synthetic_segs())
        out["kernels_hd256"] = k6 + bwd
        for r in k6 + bwd:
            print(json.dumps(r), flush=True)
        print(f"kernels_hd256: {time.monotonic() - t0:.0f} s", flush=True)
        ok &= all(r["ok"] for r in k6 + bwd)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
