#!/usr/bin/env python3
"""``chip_smoke.py``'s data- and tensor-parallel phases alone, on the
card.

    python3 scripts/torch_par_phases.py [--out records.json]
        [--phases tp_gen tp_sft realloc par_ppo] [--seeds 1 2 3 4 5]

Builds the kernels, then runs the phases ``tp_gen``, ``tp_sft``,
``realloc`` and ``par_ppo`` (or those ``--phases`` names), members on
``chip_smoke.member_devices`` (every member on cuda:0 with one card,
spread over cuda:0..3 with four), and, when tp_gen, tp_sft and par_ppo
all ran, K1-K4 against their plain versions at the shapes their members
launched (``chip_smoke.phase_kernels_par``). Prints each record and "OK"
when every check passed. With ``--seeds``, ``tp_gen`` and ``tp_sft`` run once per
model seed instead and only the readings their limits
(``chip_smoke.PAR_LIMITS``) rest on are printed, each sound reading
beside its planted fault's.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("tp_gen", "tp_sft", "realloc", "par_ppo")


def readings(name, rec):
    """The numbers a phase's limits rest on."""
    if name == "tp_gen":
        return {lay: dict(tf=r["tf"], fault=r.get("planted_fault"))
                for lay, r in rec["layouts"].items()}
    if name == "tp_sft":
        return {k: rec[k] for k in ("loss_rel", "grad_norm_rel",
                                    "update_rel", "planted_fault")}
    if name == "realloc":
        return dict(ema=rec["ema"], moves=rec["moves"])
    return dict(first_minibatch=rec["first_minibatch"],
                fault=rec["planted_fault"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="run tp_gen and tp_sft once per model seed for "
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
    calls = dict(tp_gen=lambda s: chip_smoke.phase_tp_gen(smi, s),
                 tp_sft=lambda s: chip_smoke.phase_tp_sft(smi, s),
                 realloc=lambda s: chip_smoke.phase_realloc(smi, s),
                 par_ppo=lambda s: chip_smoke.phase_par_ppo(smi))
    out, segs, ok = {}, {}, True
    for name in args.phases:
        for seed in (args.seeds or [1]):
            if args.seeds and name not in ("tp_gen", "tp_sft"):
                continue
            t0 = time.monotonic()
            rec = calls[name](seed)
            rec["phase_secs"] = time.monotonic() - t0
            if "_segs" in rec:
                segs[name] = rec.pop("_segs")
            key = f"{name}.seed{seed}" if args.seeds else name
            out[key] = rec
            shown = readings(name, rec) if args.seeds else rec
            print(f"{key} ({rec['phase_secs']:.0f} s): "
                  + json.dumps(shown), flush=True)
            ok &= bool(rec["ok"]) or bool(args.seeds)
    if not args.seeds and {"tp_gen", "tp_sft", "par_ppo"} <= set(segs):
        fwd, bwd = chip_smoke.phase_kernels_par(segs)
        out["kernels"] = fwd + bwd
        for r in fwd + bwd:
            print(json.dumps(r), flush=True)
        ok &= all(r["ok"] for r in fwd + bwd)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
