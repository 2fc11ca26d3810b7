#!/usr/bin/env python3
"""``chip_smoke.py``'s pipeline and decode-view phases alone, on the
card.

    python3 scripts/torch_pp_phases.py [--out records.json]
        [--phases pp_sft pp_gen pp_ppo sp_pp] [--seeds 1 2 3 4 5]

Builds the kernels, then runs the phases ``pp_sft``, ``pp_gen``,
``pp_ppo`` and ``sp_pp`` (sequence parallelism with pipeline
parallelism: t2p2s and d2t2p2s against t2p2 and d2t2p2) (or those
``--phases`` names), members on
``chip_smoke.member_devices`` (every member on cuda:0 with one card,
spread over cuda:0..3 with four), and, when pp_sft and pp_gen both ran,
K1-K4 against their plain versions at the shapes their members launched
(``chip_smoke.phase_kernels_pp``). Prints each record and "OK" when
every check passed. With ``--seeds``, ``pp_sft``, ``pp_gen`` and ``sp_pp``
run once per model seed instead and only the readings their limits
(``chip_smoke.PP_LIMITS``, ``PAR_LIMITS``) rest on are printed, each
sound reading beside its planted fault's.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("pp_sft", "pp_gen", "pp_ppo", "sp_pp")


def readings(name, rec):
    """The numbers a phase's limits rest on."""
    if name in ("pp_sft", "sp_pp"):
        keys = ("loss_rel", "grad_norm_rel", "update_rel", "logprobs_abs",
                "forward_abs", "fault_forward_abs")
        return dict(layouts={lay: {k: r[k] for k in keys if k in r}
                             for lay, r in rec["layouts"].items()},
                    fault=rec["planted_fault"])
    if name == "pp_gen":
        return dict(cases={c: r["tf"] for c, r in rec["cases"].items()},
                    fault=rec["planted_fault"])
    return dict(first_minibatch=rec["first_minibatch"],
                fault=rec["planted_fault"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="run pp_sft and pp_gen once per model seed for "
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
    calls = dict(pp_sft=lambda s: chip_smoke.phase_pp_sft(smi, s),
                 pp_gen=lambda s: chip_smoke.phase_pp_gen(smi, s),
                 pp_ppo=lambda s: chip_smoke.phase_pp_ppo(smi),
                 sp_pp=lambda s: chip_smoke.phase_sp_pp(smi, s))
    out, segs, ok = {}, {}, True
    for name in args.phases:
        for seed in (args.seeds or [1]):
            if args.seeds and name == "pp_ppo":
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
    if not args.seeds and {"pp_sft", "pp_gen"} <= set(segs):
        fwd, bwd = chip_smoke.phase_kernels_pp(segs)
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
