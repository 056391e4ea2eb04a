#!/usr/bin/env python3
"""Time schedules of the fused-norm kernels (B1–B4) against each other on
one CUDA card: ``python3 tools/fused_norm_tune.py [--parent OLD.cu]``.

Each schedule is ``tpudist_torch/ops/csrc/fused_norm.cu`` with some of its
``constexpr`` schedule constants (``FWD_UNROLL``, ``FWD_BLOCKS_PER_SM``,
``FWD_HINTS``, ``BWD_UNROLL``, ``BWD_THREADS``, ``BWD_MIN_BLOCKS``,
``BWD_BLOCKS_PER_SM``, ``BWD_MIN_SLICE``, ``BWD_HINTS``)
rewritten in a copy under ``build/fused_norm_tune/``; ``--parent`` adds an
earlier revision of the source (its entry points take no variant
argument). Every library is built at once (one ``nvcc`` each), then each
shape of ``chip_smoke.RESNET18_SHAPES`` (B1–B4) and ``ZOO_SHAPES`` (B1, B3)
is timed in bf16 with every library in turn, forwards then backwards
(CUDA events, median of 25 × 10 calls, as ``chip_smoke.time_ms``), each
output held against the plain version bit for bit (y, dx, dr) first. One
JSON line a (shape, kernel) with each library's ms and share of the bytes
bound (3.35 TB/s on an H100), then a summary line. Needs the card, nvcc and
no network; takes about two minutes (seven libraries).

``--ab DIR`` instead runs ``chip_smoke.phase_fused_norm_vs_plain`` (the
kernels through their wrappers, as the main path calls them) from the
checkout ``DIR`` (an earlier revision, unpacked with ``git archive``) and
from this one, each in its own process, in the order DIR, this, this,
DIR; one JSON line a case both revisions run, with the four kernel ms
and the ratio of this revision's best to DIR's. About two minutes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpudist_torch.ops import _build  # noqa: E402
from tpudist_torch.ops import fused_norm as fn  # noqa: E402

OUT = os.path.join(HERE, "build", "fused_norm_tune")
# Name → constants rewritten in the source ({} is the source as it is).
SCHEDULES = {
    "current": {},
    "bwd_blocks2": {"BWD_BLOCKS_PER_SM": "2"},
    "bwd_blocks8": {"BWD_BLOCKS_PER_SM": "8"},
    "bwd_unroll8": {"BWD_UNROLL": "8"},
    "bwd_threads128": {"BWD_THREADS": "128", "BWD_MIN_BLOCKS": "4"},
    "fwd_unroll2": {"FWD_UNROLL": "2"},
    "fwd_blocks32": {"FWD_BLOCKS_PER_SM": "32"},
}


def _source(consts: dict) -> str:
    with open(os.path.join(_build.CSRC_DIR, "fused_norm.cu")) as f:
        src = f.read()
    for name, value in consts.items():
        src, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise SystemExit(f"no constant {name} in fused_norm.cu")
    return src


def build(libs: dict) -> dict:
    """``{name: source text}`` → ``{name: ctypes.CDLL}``, all nvcc at once;
    the ptxas report's registers a kernel are printed."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, src in libs.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"lib{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    failed = [f"nvcc failed for {name}:\n{logs[name]}"
              for name, (_, proc) in jobs.items() if proc.returncode]
    if failed:
        raise SystemExit("\n".join(failed))
    out = {}
    for name, (so, _) in jobs.items():
        log = logs[name]
        regs = {k: [v.get("registers"), v.get("spill_stores")] for k, v in
                cs._ptxas_entries(log).items() if "bf16" in k}
        print(json.dumps({"library": name,
                          "registers_spill_stores_bf16": regs}), flush=True)
        out[name] = ctypes.CDLL(so)
    return out


def caller(lib, name: str, new_abi: bool, x, r, dy, a, b, outs):
    """A no-argument call of kernel ``name`` of ``lib`` on fixed operands
    (outputs preallocated), in the variant the wrapper would choose."""
    f = getattr(lib, f"tpudist_{name}")
    f.restype = ctypes.c_int
    m, c = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    lead = [ctypes.c_int(fn.DTYPES[x.dtype])]
    if new_abi:
        lead.append(ctypes.c_int(int(fn.variant(c, x.dtype, x, r, dy)
                                     == "vector")))
    y, dx, dr, da_p, db_p = outs
    tail = [ctypes.c_longlong(m), ctypes.c_int(c)]
    rows = [ctypes.c_int(fn.BWD_BLOCK_ROWS)]
    s = [ctypes.c_void_p(stream)]
    if name == "bn_act_fwd":
        args = [ptr(x), ptr(a), ptr(b), ptr(y), *tail, *s]
    elif name == "bn_act_fwd_res":
        args = [ptr(x), ptr(r), ptr(a), ptr(b), ptr(y), *tail, *s]
    elif name == "bn_act_bwd":
        args = [ptr(x), ptr(dy), ptr(a), ptr(b), ptr(dx), ptr(da_p),
                ptr(db_p), *tail, *rows, *s]
    else:
        args = [ptr(x), ptr(r), ptr(dy), ptr(a), ptr(b), ptr(dx), ptr(dr),
                ptr(da_p), ptr(db_p), *tail, *rows, *s]

    def call():
        err = f(*lead, *args)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


AB_PHASE = ("import json, torch, chip_smoke as cs; "
            "from tpudist_torch.ops import _build; "
            "_build.build_all(['fused_norm']); "
            "cs.phase_fused_norm_vs_plain("
            "cs.peaks_for(torch.cuda.get_device_name(0))[1])")


def ab(parent: str) -> int:
    """``--ab``: the wrappers' timings of ``parent`` and this checkout."""
    runs = []
    for tree in (parent, HERE, HERE, parent):
        out = subprocess.run([sys.executable, "-c", AB_PHASE], cwd=tree,
                             capture_output=True, text=True, check=True,
                             env=dict(os.environ, PYTHONPATH=tree))
        phase = [json.loads(ln) for ln in out.stdout.splitlines()
                 if ln.startswith('{"phase": "fused_norm_vs_plain"')][0]
        runs.append({(r["case"], r["kernel"], r["dtype"]): r["kernel_ms"]
                     for r in phase["cases"]})
    for key in runs[0]:
        if key not in runs[1]:
            continue
        before = min(runs[0][key], runs[3][key])
        after = min(runs[1][key], runs[2][key])
        print(json.dumps({"case": key[0], "kernel": key[1], "dtype": key[2],
                          "ms_in_turn": [r[key] for r in runs],
                          "ratio": after / before}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier fused_norm.cu to time "
                    "beside the schedules (old entry points)")
    ap.add_argument("--only", nargs="*", help="schedules to build")
    ap.add_argument("--ab", metavar="DIR", help="time the wrappers of the "
                    "checkout DIR against this one's instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.ab:
        return ab(os.path.abspath(args.ab))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    names = args.only or list(SCHEDULES)
    srcs = {n: _source(SCHEDULES[n]) for n in names}
    if args.parent:
        with open(args.parent) as f:
            srcs["parent"] = f.read()
    libs = build(srcs)
    hbm = cs.peaks_for(torch.cuda.get_device_name(0))[1]["hbm"]
    cases = [(lbl, m, c, True) for lbl, m, c in cs.RESNET18_SHAPES]
    cases += [(lbl, m, c, False) for lbl, m, c in cs.ZOO_SHAPES]
    summary = {n: [] for n in libs}
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, m, c, with_res in cases:
        rand = lambda *s, dt=torch.bfloat16: torch.randn(  # noqa: E731
            *s, generator=g, device="cuda").to(dt)
        x, dy = rand(m, c), rand(m, c)
        r = rand(m, c) if with_res else None
        a, b = rand(c, dt=torch.float32), rand(c, dt=torch.float32)
        nm = -(-m // fn.BWD_BLOCK_ROWS)
        outs = (torch.empty_like(x), torch.empty_like(x),
                torch.empty_like(x),
                torch.empty(nm, c, device="cuda"),
                torch.empty(nm, c, device="cuda"))
        kernels = ["bn_act_fwd", "bn_act_bwd"]
        if with_res:
            kernels += ["bn_act_fwd_res", "bn_act_bwd_res"]
        for name in kernels:
            rr = r if name.endswith("_res") else None
            fwd = name.startswith("bn_act_fwd")
            want = (fn.bn_act_fwd_plain(x, rr, a, b) if fwd
                    else fn.bn_act_bwd_plain(x, rr, dy, a, b))
            row = {"case": label, "shape": [m, c], "kernel": name,
                   "variant": fn.variant(c, x.dtype, x, rr, dy),
                   "bound_ms": cs._norm_bytes(name, m, c, 2) / hbm * 1e3}
            order = list(libs) + list(libs)[::-1]
            times = {n: [] for n in libs}
            for n in order:
                call = caller(libs[n], name, n != "parent", x, rr, dy, a, b,
                              outs)
                if not times[n]:
                    call()
                    torch.cuda.synchronize()
                    got = outs[0] if fwd else outs[1]
                    ref = want if fwd else want[0]
                    if not torch.equal(got, ref):
                        raise SystemExit(f"{n} {label} {name}: differs from "
                                         f"the plain version")
                times[n].append(cs.time_ms(call))
            for n, t in times.items():
                ms = min(t)
                row[n] = {"ms": ms, "share": row["bound_ms"] / ms,
                          "runs": t}
                summary[n].append((name, row["bound_ms"], ms))
            print(json.dumps(row), flush=True)
        del x, dy, r, outs
        torch.cuda.empty_cache()
    print(json.dumps({"summary": {
        n: {"sum_ms": sum(t for _, _, t in v),
            "sum_bound_ms": sum(bd for _, bd, _ in v),
            "worst_share_bound_ge_0.05ms": min(
                (bd / t for k, bd, t in v if bd >= 0.05 and
                 k in ("bn_act_fwd", "bn_act_bwd")), default=None)}
        for n, v in summary.items()}, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
