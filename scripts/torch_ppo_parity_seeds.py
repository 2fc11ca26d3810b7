#!/usr/bin/env python3
"""``chip_smoke.py``'s ppo_parity phase over several seeds on the card.

    python3 scripts/torch_ppo_parity_seeds.py [--seeds 12 13 14 15 16]
                                              [--out readings.json]

For each seed, one JSON line: the errors of the port's bf16 train step
(the kernels) and of the same step with the plain attention patched in,
each against a plain fp32 step on the card, the CPU fp32 step's errors
against the same reference, and the planted faults' readings. The
``PPO_PARITY_LIMITS`` of the train stats rest on these readings. Needs
one CUDA card (about 30 s a seed on an H100).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[12, 13, 14, 15, 16])
    ap.add_argument("--out", default=None,
                    help="also write every seed's whole record here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi_line(), flush=True)
    records = {}
    for seed in args.seeds:
        rec = chip_smoke.phase_ppo_parity(seed)
        records[seed] = rec
        print(json.dumps({k: rec[k] for k in (
            "seed", "errors", "plain_bf16_errors", "cpu_fp32_errors",
            "planted_fault_errors", "ok")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)
    return 0 if all(r["ok"] for r in records.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
