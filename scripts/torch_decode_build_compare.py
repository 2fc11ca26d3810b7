#!/usr/bin/env python3
"""K4/K5 built from this checkout against K4/K5 built from another source
file (another revision's ``flash_decode.cu`` with the same C entry: the
bool valid mask, the window and the slots read by the kernel), on the
card.

    python3 scripts/torch_decode_build_compare.py --other path/to/flash_decode.cu
                                                  [--hd256] [--out readings.json]

Builds this checkout's ``realhf_tpu_torch/csrc/flash_decode.cu`` (through
``ops/_build``) and the other source with the same flags, then runs each
K4/K5 case of ``chip_smoke.phase_kernels`` (the same q, caches, valid mask
and window; with ``--hd256`` the K4/K5 cases of ``phase_kernels_hd256``
instead) through both. The other build goes through this checkout's
``_launch`` on the other library's entry, this one through
``flash_decode_attention``; out, m and l must be bit-equal
(``torch.equal``) between the builds. One JSON line per case: each
build's largest row error against ``decode_attention_plain``
(``chip_smoke.row_rel_err``, the limit of phase ``kernels``) and its m
and l errors, the ms of one call
of each (``chip_smoke.queued_ms``: launches queued ahead of the device,
rotating over >= 200 MB of layer caches so each finds its cache cold;
taken in the order other, this, this, other, the two readings of each
averaged) and the host us of one wrapper call of each. Then the ptxas
register, shared-memory and spill lines of both builds. Exits 1 when this
build exceeds a limit or a case differs.
Needs one CUDA card and nvcc (about a minute on an H100).
"""

import argparse
import ctypes
import json
import os
import sys

from torch_k1_build_equal import build_other, ptxas_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def other_entry(lib):
    """The other build's wrapper: this checkout's ``_launch`` (its checks,
    then the launch) on the other library's C entry."""
    from realhf_tpu_torch.ops import decode_attention as da
    fn = lib.flash_decode_bf16
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, p, p, p, i, i, i, i, i, ll, ll, ll,
                   ctypes.c_float, i, p]
    fn.restype = i

    def launch(q, k_layer, v_layer, valid, window, slot, return_stats=False):
        saved, da._fn = da._fn, fn
        try:
            return da._launch(q, k_layer, v_layer, valid, window, slot,
                              q.shape[-1] ** -0.5, return_stats)
        finally:
            da._fn = saved
    return launch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the flash_decode.cu to hold this checkout's against")
    ap.add_argument("--out", default=None,
                    help="also write every case's record here")
    ap.add_argument("--hd256", action="store_true",
                    help="the hd 256 cases (phase_kernels_hd256)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    from realhf_tpu_torch.ops import _build
    from realhf_tpu_torch.ops import decode_attention as da
    print(chip_smoke.nvidia_smi_line(), flush=True)
    _build.library_path("flash_decode").unlink(missing_ok=True)  # log it
    _build.library("flash_decode")
    this_log = _build.build_log.get("flash_decode", "")
    other_lib, other_log = build_other(args.other, "flash_decode")
    other = other_entry(other_lib)

    # the K4/K5 cases of phase kernels, their inputs made as
    # check_flash_decode makes them
    cases = []

    def capture(name, b, S, nq, nkv, hd, spans, gen, timed, stacked_layers=0,
                layer=0, window=None):
        dev = "cuda"
        q = torch.randn((b, nq, hd), generator=gen, device=dev).bfloat16()
        n_rot = max(4, -(-200_000_000 // (2 * b * nkv * S * hd * 2)))
        shape = (n_rot, b, nkv, S, hd)
        k_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
        v_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
        valid = chip_smoke.decode_valid(b, S, spans, dev)
        slot = None
        if window is not None:
            slot = (S - 1 - valid.flip(-1).int().argmax(-1)).int()
        cases.append((name, q, k_all, v_all, valid, window, slot))
        return dict(ok=True, kernel="flash_decode")

    chip_smoke.check_flash_decode = capture
    chip_smoke.check_flash_fwd = lambda *a, **kw: dict(ok=True)
    chip_smoke.check_flash_bwd = lambda *a, **kw: dict(ok=True)
    if args.hd256:
        chip_smoke.phase_kernels_hd256()
    else:
        chip_smoke.phase_kernels()

    records = []
    ok = True
    for name, q, k_all, v_all, valid, window, slot in cases:
        n_rot = k_all.shape[0]
        keep = da.window_keep(valid, window, slot)
        ref = da.decode_attention_plain(q, k_all[0], v_all[0], keep,
                                        return_stats=True)
        rows = keep.any(-1)[:, None].expand(*q.shape[:2])
        calls = dict(
            this=lambda li=0, **kw: da.flash_decode_attention(
                q, k_all[li], v_all[li], valid, sliding_window=window,
                slot=slot, **kw),
            other=lambda li=0, **kw: other(q, k_all[li], v_all[li], valid,
                                           window, slot, **kw))
        rec = dict(case=name, shape=[*q.shape[:2], *k_all.shape[2:4],
                                     q.shape[2]], window=window,
                   kept_slots=int(keep.sum()), rotated_layers=n_rot)
        outs = {}
        for tag, call in calls.items():
            out, m, l = outs[tag] = call(return_stats=True)
            torch.cuda.synchronize()
            rec[f"row_rel_err_{tag}"] = chip_smoke.row_rel_err(out, ref[0],
                                                               rows)
            rec[f"m_max_abs_err_{tag}"] = chip_smoke.max_err(m, ref[1])
            rec[f"l_max_rel_err_{tag}"] = float(
                ((l - ref[2]).abs() / ref[2].abs().clamp_min(1e-6)).max())
        rec["bit_equal"] = all(torch.equal(a, b) for a, b in
                               zip(outs["this"], outs["other"]))
        ok &= rec["bit_equal"]
        del outs
        ok &= (rec["row_rel_err_this"]
               <= chip_smoke.LIMITS["flash_decode_row_rel"]
               and rec["m_max_abs_err_this"]
               <= chip_smoke.LIMITS["flash_decode_m"]
               and rec["l_max_rel_err_this"]
               <= chip_smoke.LIMITS["flash_decode_l_rel"])
        del ref
        rot = [i % n_rot for i in range(n_rot * max(1, -(-24 // n_rot)))]
        ms = {tag: [] for tag in calls}
        host = {tag: [] for tag in calls}
        for tag in ("other", "this", "this", "other"):
            t_ms, t_host, queued = chip_smoke.queued_ms(
                [lambda i=i, c=calls[tag]: c(i) for i in rot])
            ms[tag].append(t_ms)
            host[tag].append(t_host)
            rec.setdefault("queued", True)
            rec["queued"] &= queued
        for tag in calls:
            rec[f"ms_{tag}"] = sum(ms[tag]) / len(ms[tag])
            rec[f"host_us_{tag}"] = sum(host[tag]) / len(host[tag])
        rec["ms_all"], rec["host_us_all"] = ms, host
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del calls
        torch.cuda.empty_cache()
    ptxas = dict(this=ptxas_lines(this_log), other=ptxas_lines(other_log))
    print(json.dumps(dict(ptxas=ptxas)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(cases=records, ptxas=ptxas), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
