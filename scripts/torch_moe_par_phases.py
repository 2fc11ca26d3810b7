#!/usr/bin/env python3
"""``chip_smoke.py``'s replicated-KV and MoE-over-members phases alone,
on the card.

    python3 scripts/torch_moe_par_phases.py [--out records.json]
        [--phases kv_rep moe_tp moe_sft_par kernels mixtral_full moe_pp
                  moe_pp_train]
        [--seeds 1 2 3 4 5]

Builds the kernels, then runs the phases ``kv_rep`` (Gemma-2B at d1t2
and d1t4: generation through the decode's "seq" route, and training at
d1t2), ``moe_tp`` (``mixtral_gen`` at 16 layers first, then its engine
reallocated to d1t2 and d1t4, then ``moe_pp``: the same engine at
d1t2p2, MoE at t2 inside each pipeline stage, and its first 4 layers
generating through the layout's decode view), ``moe_sft_par`` (Mixtral
width, 1 layer, at d2t1, d2t2 with expert parallelism and c2) and
``kernels`` (K4 with its statistics at kv_rep's slices,
``chip_smoke.seq_kernel_cases``), or
those ``--phases`` names, members on ``chip_smoke.member_devices``
(every member on cuda:0 with one card, spread over cuda:0..3 with
four). ``mixtral_full`` (not run by default; four cards) is
Mixtral-8x7B at its full 32 layers at d1t4, one member a card
(``chip_smoke.phase_mixtral_full_d1t4``); ``moe_pp_train`` (not run by
default; four cards) trains Mixtral width at 2 layers at d2p2 with
expert parallelism against p2 (``chip_smoke.phase_moe_pp_train``).
``moe_pp`` alone runs mixtral_gen first. Prints each record and "OK"
when every check passed. With ``--seeds``, the phases run once per model
seed and only the readings their limits (``chip_smoke.MOE_PAR_LIMITS``)
rest on are printed, each sound reading beside its planted fault's.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("kv_rep", "moe_tp", "moe_sft_par", "kernels", "mixtral_full",
          "moe_pp", "moe_pp_train")
DEFAULT = PHASES[:4]


def readings(name, rec):
    """The numbers a phase's limits rest on."""
    if name == "kv_rep":
        return dict(gen={lay: dict(tf=r["tf"], fault=r.get("planted_fault"),
                                   decode_ms=r["decode_ms_per_token"])
                         for lay, r in rec["gen"].items()},
                    sft={k: rec["sft"][k] for k in (
                        "loss_rel", "grad_norm_rel", "update_rel",
                        "planted_fault")})
    if name == "moe_pp":
        return dict(tf=rec["tf"], tp=rec["tp"],
                    tp_bit_equal=rec["tp_bit_equal"],
                    fault=rec["planted_fault"],
                    forward_secs=rec["forward_secs"],
                    gen={k: rec["gen"][k] for k in (
                        "tf", "planted_fault", "launches_ok",
                        "decode_ms_per_token", "view_build_ms",
                        "peak_mem_gb")})
    if name == "moe_pp_train":
        return {k: rec[k] for k in ("loss_rel", "grad_norm_rel",
                                    "update_rel", "aux_rel",
                                    "planted_fault")}
    if name == "moe_tp":
        return {lay: dict(tf=r["tf"], fault=r.get("planted_fault"),
                          decode_ms=r["decode_ms_per_token"],
                          host_reads=r["host_reads_per_decode_step"])
                for lay, r in rec["layouts"].items()}
    return {lay: {k: r[k] for k in ("loss_rel", "grad_norm_rel",
                                    "update_rel", "aux_rel",
                                    "planted_fault") if k in r}
            for lay, r in rec["layouts"].items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every record here")
    ap.add_argument("--phases", nargs="*", default=list(DEFAULT),
                    choices=PHASES)
    ap.add_argument("--seeds", type=int, nargs="*", default=None,
                    help="run the phases once per model seed for readings")
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

    kept = {}

    def mixtral(seed, phase, last):
        """mixtral_gen's engine (made once a seed), then ``phase`` on it;
        ``last`` lets the engine go."""
        if kept.get("seed") != seed:
            kept.clear()
            gen = chip_smoke.phase_mixtral_gen(smi, seed, keep=kept)
            print(f"mixtral_gen.seed{seed}: ok={gen['ok']} tf={gen['tf']}",
                  flush=True)
            kept.update(seed=seed, gen_ok=gen["ok"])
            chip_smoke.free()
        rec = phase(smi, kept["engine"], kept["items"])
        rec["ok"] &= kept["gen_ok"]
        if last:
            kept.clear()
        return rec

    def moe_tp(seed):
        return mixtral(seed, chip_smoke.phase_moe_tp,
                       "moe_pp" not in args.phases)

    def moe_pp(seed):
        return mixtral(seed, chip_smoke.phase_moe_pp, True)

    calls = dict(kv_rep=lambda s: chip_smoke.phase_kv_rep(smi, s),
                 moe_tp=moe_tp,
                 moe_sft_par=lambda s: chip_smoke.phase_moe_sft_par(smi, s),
                 mixtral_full=lambda s: chip_smoke.phase_mixtral_full_d1t4(
                     smi, s),
                 moe_pp=moe_pp,
                 moe_pp_train=lambda s: chip_smoke.phase_moe_pp_train(
                     smi, s))
    out, ok = {}, True
    for name in args.phases:
        if name == "kernels":
            continue
        for seed in (args.seeds or [1]):
            t0 = time.monotonic()
            rec = calls[name](seed)
            rec["phase_secs"] = time.monotonic() - t0
            chip_smoke.free()
            key = f"{name}.seed{seed}" if args.seeds else name
            out[key] = rec
            shown = (readings(name, rec)
                     if args.seeds and name != "mixtral_full" else rec)
            print(f"{key} ({rec['phase_secs']:.0f} s): "
                  + json.dumps(shown), flush=True)
            ok &= bool(rec["ok"]) or bool(args.seeds)
    if "kernels" in args.phases and not args.seeds:
        import numpy as np
        t0 = time.monotonic()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(256)
        rng = np.random.default_rng(256)
        lengths = [int(x) for x in rng.integers(100, 513, size=8)]
        lengths[0] = 512
        recs = chip_smoke.seq_kernel_cases(gen, lengths)
        out["kernels"] = recs
        for r in recs:
            print(json.dumps(r), flush=True)
        print(f"kernels: {time.monotonic() - t0:.0f} s", flush=True)
        ok &= all(r["ok"] for r in recs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
