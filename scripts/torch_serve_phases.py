#!/usr/bin/env python3
"""``chip_smoke.py``'s serving phases alone, on the card.

    python3 scripts/torch_serve_phases.py [--out records.json]
        [--seeds 1 2 3]

Builds the kernels, runs the serving engine's kernel cases of phase
``kernels`` (K1 at batch 1 over the prefill buckets, K4 over the
inflight slots' masks), then phase ``serve_gen`` (the ``gen`` experiment
with inflight batching at LLaMA-7B, ``chip_smoke.SERVE_LAYERS`` layers)
and phase ``serve`` (the
continuous scheduler in four configurations, the KV check and its
planted faults, prefill times). Prints each record and "OK" when every
check passed. With ``--seeds``, phase ``serve`` runs once per model
seed instead and only its readings are printed: the largest
teacher-forced log-prob gap and argmax gap of each configuration, and
the KV check's row error over every layer and at layer 0 (with the
sound run's per-layer errors over the prompt's and the decoded rows):
the readings ``SERVE_LIMITS`` rest on (about 3 minutes a seed on an
H100).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(rec):
    out = {}
    for name, r in rec["configs"].items():
        for key in ("tf", "tf_v0", "tf_v1"):
            if key in r:
                out[f"{name}.{key}"] = [r[key]["tf_logprob_max_abs"],
                                        r[key]["argmax_gap_max"]]
    o = rec["configs"]["d_dense_spec4"]["oracle"]
    out["d_dense_spec4.oracle.tf"] = [o["tf_logprob_max_abs"],
                                      o["argmax_gap_max"]]
    out["d_dense_spec4.oracle.accept_rate"] = o["accept_rate"]
    kv = rec["kv_check"]
    out["kv_check"] = {k: [kv[k]["kv_row_rel_err"],
                           kv[k]["kv_layer0_row_rel_err"],
                           kv[k]["tf_logprob_max_abs"],
                           kv[k]["argmax_gap_max"]] for k in (
        "sound", "fault_positions_off_by_one",
        "fault_scatter_clamps_onto_live_rows")}
    out["kv_check_sound_by_layer"] = kv["sound"]["kv_row_rel_by_layer"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="run phase serve once per model seed for readings")
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
    if args.seeds:
        real = chip_smoke.serve_model
        for seed in args.seeds:
            chip_smoke.serve_model = lambda seed=seed: real(seed)
            t0 = time.monotonic()
            rec = chip_smoke.phase_serve(smi)
            out[f"seed{seed}"] = readings(rec)
            print(f"seed {seed} ({time.monotonic() - t0:.0f} s): "
                  + json.dumps(out[f"seed{seed}"]), flush=True)
        ok = True
    else:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        out["kernels"] = chip_smoke.serve_kernel_cases(gen)
        for r in out["kernels"]:
            print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
        for name, phase in (("serve_gen", chip_smoke.phase_serve_gen),
                            ("serve", chip_smoke.phase_serve)):
            t0 = time.monotonic()
            out[name] = phase(smi)
            print(name, time.monotonic() - t0, json.dumps(out[name]),
                  flush=True)
        ok = (all(r["ok"] for r in out["kernels"])
              and out["serve_gen"]["ok"] and out["serve"]["ok"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
