#!/usr/bin/env python3
"""K2 and K3 built from this checkout against K2 and K3 built from another
source file (another revision's ``flash_bwd.cu``), on the card.

    python3 scripts/torch_bwd_build_compare.py --other path/to/flash_bwd.cu
                                               [--out readings.json]

Builds this checkout's ``realhf_tpu_torch/csrc/flash_bwd.cu`` (through
``ops/_build``) and the other source with the same flags, then runs each
K2/K3 case of ``chip_smoke.phase_kernels_bwd`` (the same q, k, v, dO and
segment ids, o and lse from this checkout's K1) through both libraries.
One JSON line per case: each build's largest row error of dq, dk and dv
against the plain backward in fp32 (``chip_smoke.row_rel_err``, the limit
of phase ``kernels``), whether the two builds' outputs are bit-equal
(``torch.equal``) and their largest difference, and
the ms of one dq and one dk/dv call of each (CUDA events over 20
launches, taken in the order other, this, this, other; the two readings
of each averaged). Then the ptxas register, shared-memory and spill lines
of both builds. Exits 1 when this build exceeds a row limit. Needs one
CUDA card and nvcc (a minute or two on an H100).
"""

import argparse
import json
import os
import sys

from torch_k1_build_equal import build_other, ptxas_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the flash_bwd.cu to hold this checkout's against")
    ap.add_argument("--out", default=None,
                    help="also write every case's record here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    from realhf_tpu_torch.ops import _build
    from realhf_tpu_torch.ops import flash_attention as fa
    print(chip_smoke.nvidia_smi_line(), flush=True)
    _build.library_path("flash_bwd").unlink(missing_ok=True)  # log it
    this = _build.library("flash_bwd")
    this_log = _build.build_log.get("flash_bwd", "")
    other, other_log = build_other(args.other, "flash_bwd")

    def use(lib):
        _build._libs["flash_bwd"] = lib
        fa._fns.clear()

    # the K2/K3 cases of phase kernels, their inputs made as
    # check_flash_bwd makes them
    cases = []

    def capture(name, b, L, nq, nkv, hd, seg, causal, gen, timed,
                plant_fault=False):
        dev = seg.device
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((b, L, nq, hd), (b, L, nkv, hd),
                                 (b, L, nkv, hd)))
        do = torch.randn((b, L, nq, hd), generator=gen, device=dev).bfloat16()
        cases.append((name, q, k, v, do, seg, causal))
        return dict(ok=True)

    chip_smoke.check_flash_bwd = capture
    chip_smoke.phase_kernels_bwd()

    records = []
    ok = True
    for name, q, k, v, do, seg, causal in cases:
        o, lse = fa.flash_attention(q, k, v, seg, causal=causal)
        delta = fa.attention_delta(o, do)
        kw = dict(causal=causal)

        def dq_call():
            return fa.flash_bwd_dq(q, k, v, seg, do, lse, delta, **kw)

        def dkv_call():
            return fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta, **kw)

        ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                           seg, o.float(), lse, do.float(),
                                           **kw)
        tok = seg != 0
        rows = dict(dq=tok[:, :, None].expand(*q.shape[:3]),
                    dk=tok[:, :, None].expand(*k.shape[:3]))
        rows["dv"] = rows["dk"]
        outs = {}
        for tag, lib in (("this", this), ("other", other)):
            use(lib)
            outs[tag] = dict(zip(("dq", "dk", "dv"), (dq_call(), *dkv_call())))
        torch.cuda.synchronize()
        rec = dict(case=name, shape=list(q.shape) + [k.shape[2]],
                   causal=causal)
        for key, want in zip(("dq", "dk", "dv"), ref):
            for tag in ("this", "other"):
                rec[f"{key}_row_rel_err_{tag}"] = chip_smoke.row_rel_err(
                    outs[tag][key], want, rows[key], 0.01)
            rec[f"{key}_equal"] = bool(torch.equal(outs["this"][key],
                                                   outs["other"][key]))
            rec[f"{key}_max_abs_diff"] = chip_smoke.max_err(
                outs["this"][key], outs["other"][key])
            ok &= (rec[f"{key}_row_rel_err_this"]
                   <= chip_smoke.LIMITS[f"flash_bwd_{key}_row_rel"])
        del ref, outs
        ms = {f"{fn}_{tag}": [] for fn in ("dq", "dkv")
              for tag in ("this", "other")}
        for tag in ("other", "this", "this", "other"):
            use(this if tag == "this" else other)
            ms[f"dq_{tag}"].append(chip_smoke.cuda_ms(dq_call))
            ms[f"dkv_{tag}"].append(chip_smoke.cuda_ms(dkv_call))
        for key, vals in ms.items():
            rec[f"{key}_ms"] = sum(vals) / len(vals)
        rec["ms_all"] = ms
        records.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    use(this)
    ptxas = dict(this=ptxas_lines(this_log), other=ptxas_lines(other_log))
    print(json.dumps(dict(ptxas=ptxas)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(cases=records, ptxas=ptxas), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
