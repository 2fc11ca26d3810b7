#!/usr/bin/env python3
"""``chip_smoke.py``'s two checkpoint phases alone, on the card.

    python3 scripts/torch_ckpt_phases.py [--out records.json]

Builds the kernels, then runs phase ``ckpt_gen`` (the LLaMA-7B gen
model at ``chip_smoke.CKPT_GEN_LAYERS`` layers saved streamed and loaded
into a new gen runner: weights bit-equal to the saved model's and to the
registry's eager load, equal greedy tokens, exact K1/K4 counts, the
q_proj fault) and phase ``ckpt_resume`` (the sft cell at 7B width,
``chip_smoke.CKPT_RESUME_LAYERS`` layers, interrupted
after step 2 and resumed: step 3 bit-equal, exact K1-K3 counts, the
fresh-moments fault). Prints each phase's seconds and JSON record, and
"OK" when both passed. Needs one CUDA card, ~30 GB of free disk under
``_ckpt_scratch/`` and ~30 GB of host memory (about 4 minutes on an
H100).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write both phases' records here")
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
    out = {}
    for name, phase in (("ckpt_gen", chip_smoke.phase_ckpt_gen),
                        ("ckpt_resume", chip_smoke.phase_ckpt_resume)):
        t0 = time.monotonic()
        out[name] = phase(smi)
        print(name, time.monotonic() - t0, json.dumps(out[name]),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    ok = all(r["ok"] for r in out.values())
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
