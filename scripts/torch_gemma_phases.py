#!/usr/bin/env python3
"""``chip_smoke.py``'s head-dim-256 and GPT-2 XL phases alone, on the
card.

    python3 scripts/torch_gemma_phases.py [--out records.json]
        [--phases kernels gemma_gen gemma_sft gemma_parity gpt2_gen]
        [--seeds 1 2 3 4 5]

Builds the kernels and prints ptxas's register and spill lines of each
library, then runs the hd 256 cases of phase ``kernels``
(``phase_kernels_hd256``) and the phases ``gemma_gen``, ``gemma_sft``,
``gemma_parity`` and ``gpt2_gen`` (or those ``--phases`` names). Prints
each record and "OK" when every check passed. With ``--seeds``,
``gemma_gen``, ``gemma_parity`` and ``gpt2_gen`` run once per model
seed instead (``gemma_sft`` has no limit of its own) and only the
readings their limits (``chip_smoke.GEMMA_LIMITS``) rest on are
printed, each sound reading beside its planted faults'.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("kernels", "gemma_gen", "gemma_sft", "gemma_parity", "gpt2_gen")


def readings(name, rec):
    """The numbers a phase's limits rest on."""
    if name == "gemma_parity":
        return {k: rec[k] for k in (
            "stream_logits_rel_err", "prefill_logits_rel_err",
            "decode_logits_rel_err", "loss_rel_err", "grad_norm_rel_err",
            "min_cos", "planted_fault_min_cos")}
    return dict(tf=rec["tf"], faults=rec["planted_faults"])


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
    for name, log in _build.build_log.items():
        print(f"ptxas {name}: " + json.dumps(
            [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]), flush=True)
    calls = dict(
        gemma_gen=lambda seed: chip_smoke.phase_gemma_gen(smi, seed),
        gemma_sft=lambda seed: chip_smoke.phase_gemma_sft(smi),
        gemma_parity=lambda seed: chip_smoke.phase_gemma_parity(seed),
        gpt2_gen=lambda seed: chip_smoke.phase_gpt2_gen(smi, seed))
    out, ok = {}, True
    if args.seeds:
        for name in args.phases:
            if name in ("kernels", "gemma_sft"):
                continue
            for seed in args.seeds:
                t0 = time.monotonic()
                rec = calls[name](seed)
                out[f"{name}.seed{seed}"] = readings(name, rec)
                print(f"{name} seed {seed} ({time.monotonic() - t0:.0f} s): "
                      + json.dumps(out[f"{name}.seed{seed}"]), flush=True)
    else:
        if "kernels" in args.phases:
            fwd, bwd = chip_smoke.phase_kernels_hd256()
            out["kernels"] = fwd + bwd
            for r in fwd + bwd:
                print(json.dumps(dict(phase="kernels", card=smi, **r)),
                      flush=True)
                ok &= r["ok"]
        for name in args.phases:
            if name == "kernels":
                continue
            t0 = time.monotonic()
            rec = calls[name](1)
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
