#!/usr/bin/env python3
"""The context-parallel path of ``chip_smoke.py`` alone, for a machine of
several cards: K6's cases against the plain ring (phase ``kernels``' ring
cases and the push kernel), then phase ``ctx`` (c4 against c1 at
LLaMA-7B over 32768 tokens), with the members on
``chip_smoke.member_devices`` (cuda:0..3 on four cards).

    python3 scripts/torch_ring_cards.py [--out records.json]

Prints each record as ``chip_smoke.py`` does, then the card line. Exits
1 when a check fails (about 3 minutes on four H100s).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    import chip_smoke
    smi = chip_smoke.nvidia_smi_line()
    recs = chip_smoke.phase_kernels_ring()
    for r in recs:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    ctx = chip_smoke.phase_ctx(smi)
    print(json.dumps(dict(phase="ctx", **ctx)), flush=True)
    print(smi, torch.cuda.device_count(), "cards", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(kernels=recs, ctx=ctx), f, indent=1)
    return 0 if all(r["ok"] for r in recs) and ctx["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
