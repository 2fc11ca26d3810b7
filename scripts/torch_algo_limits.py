#!/usr/bin/env python3
"""The readings under ``chip_smoke.py``'s algorithm-phase limits, over
several seeds on the card.

    python3 scripts/torch_algo_limits.py [--seeds 1 2 3 4 5]
                                         [--out readings.json]

For each seed, one JSON line per check: ``rw_parity`` (loss and grad
norm of a card bf16 ``paired_rw`` step against the CPU fp32 one, seed
``6 + seed``; the swapped-pairs fault), phase dpo (step 1's |loss - ln
2|, |kl|, the larger |score|, against a copied ref; the swapped-ref
fault) and phase grpo (each step's first-minibatch importance weight,
step 1's grpo_kl against a copied ref; the shifted-log-prob fault).
``RW_PARITY_LIMITS``, ``DPO_STEP1_LIMITS`` and ``GRPO_KL_LIMIT`` rest
on these readings: each about 3x the largest sound one. Needs one CUDA
card (about 15 s a seed on an H100).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--out", default=None,
                    help="also write every seed's whole records here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    import chip_smoke
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    records = {}
    for seed in args.seeds:
        rw = chip_smoke.rw_parity(6 + seed)
        dpo = chip_smoke.phase_dpo(smi, seed)
        grpo = chip_smoke.phase_grpo(smi, seed)
        records[seed] = dict(rw_parity=rw, dpo=dpo, grpo=grpo)
        print(json.dumps(dict(seed=seed, check="rw_parity", **{
            k: rw[k] for k in ("loss_rel_err", "grad_norm_rel_err",
                               "planted_fault_loss_rel_err", "ok")})),
            flush=True)
        print(json.dumps(dict(seed=seed, check="dpo", step1=dpo["step1"],
                              planted_fault_loss_ln2=dpo[
                                  "planted_fault_loss_ln2"],
                              ok=dpo["ok"])), flush=True)
        print(json.dumps(dict(seed=seed, check="grpo",
                              first_minibatch=grpo["first_minibatch"],
                              planted_fault_importance_weight=grpo[
                                  "planted_fault_importance_weight"],
                              ok=grpo["ok"])), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)
    return 0 if all(r["ok"] for rec in records.values()
                    for r in rec.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
