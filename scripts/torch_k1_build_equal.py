#!/usr/bin/env python3
"""K1 built from this checkout against K1 built from another source file
of it (another revision's ``flash_fwd.cu``), on the card.

    python3 scripts/torch_k1_build_equal.py --other path/to/flash_fwd.cu
                                            [--out readings.json]

Builds this checkout's ``realhf_tpu_torch/csrc/flash_fwd.cu`` (through
``ops/_build``) and the other source with the same flags, then runs each
K1 case of ``chip_smoke.phase_kernels`` (the same q, k, v and segment
ids) through both libraries. One JSON line per case: whether o and lse
are bit-equal (``torch.equal``), the largest difference of each, and the
ms of one call of each (CUDA events over 20 launches, taken in the order
other, this, this, other; the two readings of each averaged). Then the
ptxas register, shared-memory and spill lines of both builds. Exits 1
when a case differs. Needs one CUDA card and nvcc (a minute on an H100).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_other(src, name="flash_fwd"):
    """(library, ptxas log) of ``src`` built with the port's flags, as
    the library ``name``-other."""
    from realhf_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{name}-other.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I",
           os.path.dirname(os.path.abspath(src)), "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    return ctypes.CDLL(str(out)), log


#: the C entry points of each attention library and their pointer counts
#: in sources from before the ring round (no ``segk``)
ENTRIES = {"flash_fwd": {"flash_fwd_bf16": 6},
           "flash_bwd": {"flash_bwd_dq_bf16": 8, "flash_bwd_dkv_bf16": 9}}


def use_library(name, lib, src=None):
    """Makes the wrappers launch ``lib`` as the library ``name``. A
    ``src`` whose K2/K3 entries predate the ring round (no ``segk``) is
    called with its own argument list: the keys' ids and the round's
    offsets left out (a plain call passes seg, 0, 0, 0 there). One from
    before the kernels took a window (no ``int window``) is called without
    the window too. So such a build's plain launches can be held against
    this checkout's."""
    from realhf_tpu_torch.ops import _build
    from realhf_tpu_torch.ops import flash_attention as fa
    _build._libs[name] = lib
    fa._fns.clear()
    if src is None:
        return
    text = open(src).read()
    windowed = "int window" in text
    ringed = name != "flash_bwd" or "segk" in text
    if windowed and ringed:
        return
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry, n_ptrs in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = ([p] * n_ptrs + [i] * 5 + [ctypes.c_float, i]
                       + [i] * windowed + [p])
        fn.restype = i

        def call(*a, fn=fn, n_ptrs=n_ptrs):
            a = list(a)
            if not ringed:
                # this checkout's K2/K3: n_ptrs + 1 pointers (segk 5th),
                # B..hd, q_off, k_off, out_f32, scale, causal, window,
                # stream
                if a[4] != a[3] or a[n_ptrs + 6:n_ptrs + 9] != [0, 0, 0]:
                    raise ValueError(f"{src} takes no ring round")
                a = a[:4] + a[5:n_ptrs + 6] + a[n_ptrs + 9:]
            if not windowed:
                a = a[:-2] + a[-1:]
            return fn(*a)
        fa._fns[entry] = call


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the flash_fwd.cu to hold this checkout's against")
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
    this = _build.library("flash_fwd")
    this_log = _build.build_log.get("flash_fwd", "")
    other, other_log = build_other(args.other)

    def use(lib):
        use_library("flash_fwd", lib, args.other if lib is other else None)

    # the K1 cases of phase kernels, their inputs made as check_flash_fwd
    # makes them; the decode cases are not run
    cases = []

    def capture(name, b, L, nq, nkv, hd, seg, causal, gen, timed,
                plant_fault=False):
        dev = seg.device
        q, k, v = (torch.randn((b, L, h, hd), generator=gen,
                               device=dev).bfloat16()
                   for h in (nq, nkv, nkv))
        cases.append((name, q, k, v, seg, causal))
        return dict(ok=True)

    chip_smoke.check_flash_fwd = capture
    chip_smoke.check_flash_decode = lambda *a, **kw: dict(ok=True)
    chip_smoke.phase_kernels()

    records = []
    for name, q, k, v, seg, causal in cases:
        def call():
            return fa.flash_attention(q, k, v, seg, causal=causal)
        use(this)
        o, lse = call()
        use(other)
        o_other, lse_other = call()
        torch.cuda.synchronize()
        ms = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            use(this if tag == "this" else other)
            ms[tag].append(chip_smoke.cuda_ms(call))
        rec = dict(case=name, shape=list(q.shape) + [k.shape[2]],
                   causal=causal,
                   o_equal=bool(torch.equal(o, o_other)),
                   lse_equal=bool(torch.equal(lse, lse_other)),
                   o_max_abs_diff=chip_smoke.max_err(o, o_other),
                   lse_max_abs_diff=chip_smoke.max_err(lse, lse_other),
                   ms_this=sum(ms["this"]) / 2,
                   ms_other=sum(ms["other"]) / 2, ms_all=ms)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    use(this)
    ptxas = dict(this=ptxas_lines(this_log), other=ptxas_lines(other_log))
    print(json.dumps(dict(ptxas=ptxas)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(cases=records, ptxas=ptxas), f, indent=1)
    return 0 if all(r["o_equal"] and r["lse_equal"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
