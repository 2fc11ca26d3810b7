#!/usr/bin/env python3
"""``chip_smoke.py``'s mixture-of-experts and sliding-window phases
alone, on the card.

    python3 scripts/torch_moe_phases.py [--out records.json]
        [--phases kernels mixtral_gen mixtral_sft mixtral_parity mistral]
        [--seeds 1 2 3 4 5]

Builds the kernels, then runs the windowed K1 and K2/K3 cases of phase
``kernels`` (the Mistral-7B prefill shape, a packed stream at window
300, a window of 24 at hd 64 with its planted fault) and the phases
``mixtral_gen``, ``mixtral_sft``, ``mixtral_parity`` and ``mistral``
(or those ``--phases`` names). Prints each record and "OK" when every
check passed. With ``--seeds``, ``mixtral_gen``, ``mixtral_parity`` and
``mistral`` run once per model seed instead (``mixtral_sft`` has no
limit of its own) and only the readings their limits
(``chip_smoke.MOE_LIMITS``) rest on are printed, each sound reading
beside its planted faults' (about 2 minutes a seed on an H100).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("kernels", "mixtral_gen", "mixtral_sft", "mixtral_parity",
          "mistral")


def readings(name, rec):
    """The numbers a phase's limits rest on."""
    if name == "mixtral_gen":
        return dict(tf=rec["tf"], faults=rec["planted_faults"],
                    routing_differs_share=rec["routing_differs_share"])
    if name == "mixtral_parity":
        return {k: rec[k] for k in (
            "logits_rel_err", "logits_rel_err_own_routing", "routing_moved",
            "moved_max_cpu_margin", "router_logits_max_abs_err_unmoved",
            "loss_rel_err", "aux_rel_err", "grad_norm_rel_err", "min_cos",
            "planted_fault_min_cos")}
    return {k: rec[k] for k in (
        "tf", "tf_long", "planted_fault_tf", "planted_fault_tf_long",
        "fp32_logits_rel_err", "fp32_logits_rel_err_without_window")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="run the gated phases once per model seed for "
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
    calls = dict(
        mixtral_gen=lambda seed: chip_smoke.phase_mixtral_gen(smi, seed),
        mixtral_sft=lambda seed: chip_smoke.phase_mixtral_sft(smi),
        mixtral_parity=lambda seed: chip_smoke.phase_mixtral_parity(seed),
        mistral=lambda seed: chip_smoke.phase_mistral(smi, seed))
    out, ok = {}, True
    if args.seeds:
        for name in args.phases:
            if name in ("kernels", "mixtral_sft"):
                continue
            for seed in args.seeds:
                t0 = time.monotonic()
                rec = calls[name](seed)
                out[f"{name}.seed{seed}"] = readings(name, rec)
                print(f"{name} seed {seed} ({time.monotonic() - t0:.0f} s): "
                      + json.dumps(out[f"{name}.seed{seed}"]), flush=True)
    else:
        if "kernels" in args.phases:
            fwd, bwd = chip_smoke.phase_kernels_window()
            out["kernels"] = fwd + bwd
            for r in fwd + bwd:
                print(json.dumps(dict(phase="kernels", card=smi, **r)),
                      flush=True)
                ok &= r["ok"]
        for name in args.phases:
            if name == "kernels":
                continue
            t0 = time.monotonic()
            rec = calls[name](1 if name != "mixtral_parity" else 5)
            rec["phase_secs"] = time.monotonic() - t0
            out[name] = rec
            print(json.dumps(dict(phase=name, **rec)), flush=True)
            ok &= rec["ok"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
