#!/usr/bin/env python3
"""``chip_smoke.py``'s phases of the serving engine over members alone,
on the card.

    python3 scripts/torch_serve_par_phases.py [--out records.json]
        [--phases serve_par serve_rep serve_gen_view] [--configs a b c d]

Builds the kernels, then runs ``serve_par`` (the continuous scheduler
over d2t2 and d1t4 members at LLaMA-7B width, ``--configs`` picking its
configurations by letter: (a) dense with a weight push, (b) paged with
the pooled prefix cache, (c) paged int8, (d) speculative), ``serve_rep``
(Gemma-2B at d1t2, the "seq" route) and ``serve_gen_view`` (the ``gen``
experiment with inflight batching through the decode views of p2 and
c4g4 engines), or those ``--phases`` names. Members sit on
``chip_smoke.member_devices``: all on cuda:0 with one card, spread over
cuda:0..3 with four. Prints each record and "OK" when every check
passed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("serve_par", "serve_rep", "serve_gen_view")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--configs", nargs="*", default=list("abcd"),
                    choices=list("abcd"))
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
    print(f"cards: {torch.cuda.device_count()}", flush=True)
    _build.build()
    calls = dict(
        serve_par=lambda: chip_smoke.phase_serve_par(
            smi, only="".join(args.configs)),
        serve_rep=lambda: chip_smoke.phase_serve_rep(smi),
        serve_gen_view=lambda: chip_smoke.phase_serve_gen_view(smi))
    out, ok = {}, True
    for name in args.phases:
        t0 = time.monotonic()
        rec = calls[name]()
        rec["phase_secs"] = time.monotonic() - t0
        out[name] = rec
        print(f"{name} ({rec['phase_secs']:.0f} s): " + json.dumps(rec),
              flush=True)
        ok &= bool(rec["ok"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
