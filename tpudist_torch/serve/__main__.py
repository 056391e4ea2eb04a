"""CLI: ``python -m tpudist_torch.serve`` — build a model and serve it.

Counterpart of ``python -m tpudist.serve``: the same flags and the same
``SERVE_SUMMARY`` line, plus ``--device {cuda,cpu}`` (default ``cuda``;
nothing falls back to the CPU). One process is one serving replica: it
warms its bucket set, starts the continuous batcher and drives itself
with synthetic open-loop traffic (``--load-rate``/``--load-duration``);
a zero rate just warms up and reports.

Not in the port yet, each refused with a message that names it:
``--flash auto``, ``--compile-cache``, ``--metrics-port`` and a non-empty
``--checkpoint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.serve",
        description="Serve a model with the PyTorch port: bucket warm-up + "
                    "continuous batching + telemetry")
    p.add_argument("-a", "--arch", default="vit_b_16")
    p.add_argument("--checkpoint", default="",
                   help="'' = fresh init weights from --seed (bench/smoke); "
                        "loading a checkpoint is not in the port yet")
    p.add_argument("--num-classes", type=int, default=1000,
                   dest="num_classes")
    p.add_argument("--image-size", type=int, default=224, dest="image_size")
    p.add_argument("--buckets", default="1,2,4,8",
                   help="comma-separated micro-batch bucket sizes; every "
                        "request batch is padded to the smallest fitting "
                        "bucket")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   dest="max_wait_ms",
                   help="how long the batcher holds a micro-batch open for "
                        "more requests to coalesce")
    p.add_argument("--compile-cache", default="", dest="compile_cache",
                   help="not in the port yet")
    p.add_argument("--flash", default="on", choices=("auto", "on", "off"),
                   help="attention backend for vit archs: on = the "
                        "hand-written flash kernel, off = plain attention "
                        "(auto is not in the port yet)")
    p.add_argument("--load-rate", type=float, default=0.0, dest="load_rate",
                   help="synthetic open-loop arrivals per second (0 = no "
                        "load: warm up, report, exit)")
    p.add_argument("--load-duration", type=float, default=10.0,
                   dest="load_duration",
                   help="seconds of synthetic load")
    p.add_argument("--load-batch", type=int, default=1, dest="load_batch",
                   help="rows per synthetic request")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outpath", default="",
                   help="run dir for telemetry (required with --telemetry)")
    p.add_argument("--telemetry", action="store_true",
                   help="write events.<rank>.jsonl (serve_start/request/"
                        "serve_batch + compile events) + heartbeats")
    p.add_argument("--metrics-port", type=int, default=-1,
                   dest="metrics_port", help="not in the port yet")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs (default cuda; there is no "
                        "fallback to the CPU)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.telemetry and not args.outpath:
        parser.error("--telemetry needs --outpath")
    if args.flash == "auto":
        parser.error("--flash auto needs the attention dispatch layer "
                     "(ops/dispatch + ops/attention_dispatch), which the "
                     "port does not have yet; pass --flash on or off")
    if args.compile_cache:
        parser.error("--compile-cache: the port has no persistent compile "
                     "cache yet (its counterpart, CUDA graphs per bucket, "
                     "is later work)")
    if args.metrics_port >= 0:
        parser.error("--metrics-port: the port has no metrics endpoint "
                     "(obs/server.py) yet")
    if args.checkpoint:
        parser.error("--checkpoint: the port cannot read tpudist .msgpack "
                     "checkpoints yet; serve fresh weights with "
                     "--checkpoint ''")

    import numpy as np
    import torch

    from tpudist_torch import telemetry as telemetry_lib
    from tpudist_torch._device import resolve_device
    from tpudist_torch.serve.batching import (ContinuousBatcher,
                                              open_loop_load, parse_buckets)
    from tpudist_torch.serve.engine import ServeEngine
    from tpudist_torch.serve.export import load_serve_state

    buckets = parse_buckets(args.buckets)
    device = resolve_device(args.device)

    def log(msg: str) -> None:
        print(msg, flush=True)

    telemetry = None
    rank = 0
    try:
        rank = int(os.environ.get("TPUDIST_PROCESS_ID", "0"))
    except ValueError:
        pass
    if args.telemetry:
        os.makedirs(args.outpath, exist_ok=True)
        telemetry = telemetry_lib.Telemetry(args.outpath, rank=rank)
        on_gpu = device.type == "cuda"
        telemetry.emit("run_start", platform="gpu" if on_gpu else "cpu",
                       n_devices=torch.cuda.device_count() if on_gpu else 1,
                       device_kind=(torch.cuda.get_device_name(device)
                                    if on_gpu else "cpu"),
                       arch=args.arch, global_batch=buckets[-1],
                       mode="serve")

    model = load_serve_state(
        args.arch, args.checkpoint, num_classes=args.num_classes,
        image_size=args.image_size, flash=args.flash, seed=args.seed,
        device=device, log=log)
    engine = ServeEngine(model, image_size=args.image_size, buckets=buckets,
                         device=device, telemetry=telemetry, log=log)

    summary = {"arch": args.arch, "buckets": list(buckets),
               "aot_s": round(engine.aot_s, 3),
               "aot_compile_s": round(engine.aot_s, 3),
               "cache": "off", "rank": rank}
    t_serve0 = time.perf_counter()
    if args.load_rate > 0:
        batcher = ContinuousBatcher(engine,
                                    max_wait_s=args.max_wait_ms / 1e3,
                                    telemetry=telemetry)
        shape = (args.load_batch, args.image_size, args.image_size, 3)

        def make_images(rng):
            return rng.standard_normal(shape).astype(np.float32)

        log(f"=> serving synthetic open-loop load: {args.load_rate} req/s "
            f"for {args.load_duration}s")
        results = open_loop_load(batcher, args.load_rate,
                                 args.load_duration, make_images,
                                 seed=args.seed)
        batcher.close()
        # Engine errors complete the future with .error set instead of
        # raising out of the load run, so shutdown (run_end, the summary)
        # still runs when requests failed.
        ok = [r for r in results if r.error is None]
        n_errors = len(results) - len(ok)
        lats = sorted(r.latency_s for r in ok)
        span = max(time.perf_counter() - t_serve0, 1e-9)
        pct = telemetry_lib.percentile
        summary.update(
            n_requests=len(results), n_errors=n_errors,
            achieved_req_s=round(len(ok) / span, 2),
            latency_p50_ms=(round(pct(lats, 50) * 1e3, 3) if lats else None),
            latency_p99_ms=(round(pct(lats, 99) * 1e3, 3) if lats else None))
        if lats:
            log(f"=> served {len(ok)} requests: p50 "
                f"{summary['latency_p50_ms']:.1f} ms, p99 "
                f"{summary['latency_p99_ms']:.1f} ms, "
                f"{summary['achieved_req_s']:.1f} req/s"
                + (f" ({n_errors} errored)" if n_errors else ""))
        else:
            first_err = next(r.error for r in results
                             if r.error is not None)
            log(f"=> every request errored ({n_errors} of {n_errors}; "
                f"first: {first_err!r})")

    if telemetry is not None:
        telemetry.close(mode="serve")
    print("SERVE_SUMMARY " + json.dumps(summary), flush=True)
    # Partial errors still count as a served run (reported above); a run
    # where nothing succeeded is a failure — after clean shutdown.
    if summary.get("n_requests") and not (summary["n_requests"]
                                          - summary.get("n_errors", 0)):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
