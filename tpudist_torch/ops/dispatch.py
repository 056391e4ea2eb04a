"""Measurement-honest kernel dispatch: the generic layer.

Counterpart of ``tpudist/ops/dispatch.py``. Two clients register here:
``attention_dispatch`` (``--flash``: the flash kernels B5–B7 against plain
attention) and ``norm_dispatch`` (``--fused-bn``: the fused epilogue
kernels B1–B4 against the plain epilogue). One timing harness, one cache
format, one policy:

- ``decide()`` resolves ``auto`` by timing candidate against baseline on
  the card at the exact workload key and picks the winner. A candidate is
  chosen only by a strict win: a tie keeps the plain side.
- Verdicts are cached in one JSON file per client and card
  (``<client>.<device kind>.json``, version 1) under
  ``TPUDIST_DISPATCH_CACHE`` or ``~/.cache/tpudist``, keyed by the
  workload key and the client's kernel revision, so a rebuilt kernel is
  measured again. A torn or corrupt file reads as empty (the workload is
  measured again); a cache dir that cannot be written keeps the verdict in
  an in-process overlay that ``lookup()`` reads after the file.
- Off the card (``platform`` is a tensor's device type), ``auto`` resolves
  to the plain side at once: no measurement, no kernel build.
- ``lookup()`` reads the platform and the cache only and never measures.
- ``shared_decision()`` gives a data-parallel gang one verdict: rank 0
  decides and the process group carries its decision to the others.

``measure_pair`` is injectable, so the policy is testable on the CPU with
made-up timings.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import statistics
import time
from typing import Callable, Optional

import torch

MODES = ("auto", "on", "off")

ENV_CACHE_DIR = "TPUDIST_DISPATCH_CACHE"
CACHE_VERSION = 1

# The platform whose verdicts are measured; anything else takes the plain
# side under auto.
ACCELERATOR = "cuda"


def default_cache_dir() -> str:
    """``TPUDIST_DISPATCH_CACHE`` or ``~/.cache/tpudist``: outside the run
    dir, so ``--overwrite delete`` keeps the measurement the next run
    needs."""
    env = os.environ.get(ENV_CACHE_DIR, "")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "tpudist")


def _slug(device_kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "-", device_kind.strip()) or "unknown"


def cache_path(client: str, device_kind: str,
               cache_dir: Optional[str] = None) -> str:
    """One JSON file per client per device kind: ``<client>.<kind>.json``."""
    return os.path.join(cache_dir or default_cache_dir(),
                        f"{client}.{_slug(device_kind)}.json")


def card_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``): a verdict taken on
    one kind of card never dispatches another."""
    return torch.cuda.get_device_name(device)


def load_cache(path: str) -> dict:
    """The cache file's contents, or an empty shell when it is missing,
    torn or of another version."""
    try:
        with open(path) as f:
            obj = json.load(f)
        if isinstance(obj, dict) and obj.get("version") == CACHE_VERSION \
                and isinstance(obj.get("entries"), dict):
            return obj
    except (OSError, ValueError):
        pass
    return {"version": CACHE_VERSION, "entries": {}}


# (path, key) -> entry, filled only when a measured verdict could not be
# written (a read-only cache dir): the verdict a run reported must still
# hold for its own lookup()s. In-process only; the next run measures again.
_local_entries: dict = {}


def seed_local(path: str, key: str, entry: dict) -> None:
    """Keep one verdict in process when the cache file cannot be written;
    ``lookup()`` reads it after the file."""
    _local_entries[(path, key)] = entry


def save_cache(path: str, cache: dict) -> None:
    """Atomic write (a temporary file, then a rename): a rank stopped
    mid-save leaves no torn JSON behind."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def clear_cache(client: str, device_kind: Optional[str] = None,
                cache_dir: Optional[str] = None) -> int:
    """Drop one client's cached verdicts (every device kind, or one).
    Returns the number of cache files removed."""
    d = cache_dir or default_cache_dir()
    if device_kind is not None:
        paths = [cache_path(client, device_kind, d)]
    else:
        try:
            paths = [os.path.join(d, n) for n in os.listdir(d)
                     if n.startswith(f"{client}.") and n.endswith(".json")]
        except OSError:
            paths = []
    removed = 0
    for p in paths:
        for k in [k for k in _local_entries if k[0] == p]:
            del _local_entries[k]
        try:
            os.remove(p)
            removed += 1
        except OSError:
            pass
    return removed


def measure_ms(fn, args, steps: int = 10, warmup: int = 2,
               repeats: int = 3) -> float:
    """Device ms a call of ``fn(*args)``: ``warmup`` calls, then the median
    over ``repeats`` of the mean of ``steps`` calls between two CUDA
    events. Each repeat first queues a spin on the card long enough for
    the host to queue all ``steps`` calls behind it, so the events time
    the card and not the host that feeds it (an eager epilogue's host
    pace outlasts its device time below resnet18's stem). A repeat the
    host fell behind (the start event had run by the time the last call
    was queued) spins four times longer and runs again; the third such
    repeat raises, as does an ``fn`` that waits on the card."""
    host_s = 0.0
    for _ in range(max(warmup, 1)):
        t0 = time.perf_counter()
        fn(*args)
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # Twice the host's pace of the last warm call, at 2 GHz (an H100's
    # boost clock is 1.98), and at most a second to start with.
    cycles = int(min(max(2 * steps * host_s, 1e-3), 1.0) * 2e9)
    times, behind = [], 0
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(steps):
            fn(*args)
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / steps)
            continue
        behind += 1
        if behind == 3:
            raise RuntimeError(
                f"measure_ms: the host fell behind the card three times, "
                f"the last behind a spin of {cycles / 2e9:.2f} s: the call "
                f"waits on the card, and events would time the host")
        cycles *= 4
    return statistics.median(times)


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def decide(client: str, key: str, *, mode: str,
           names: tuple[str, str],
           kernel_rev: Callable[[], int],
           measure_pair: Callable[[], tuple[float, float]],
           eligibility: Optional[tuple[bool, str]] = None,
           cache_dir: Optional[str] = None,
           platform: Optional[str] = None,
           device_kind: Optional[str] = None) -> dict:
    """Resolve one workload for one client. ``names = (candidate,
    baseline)``; the decision carries ``kernel`` (one of them), ``mode``,
    ``source`` ("forced" | "platform" | "ineligible" | "cache" |
    "measured"), ``<candidate>_ms``/``<baseline>_ms``/``margin`` when
    measured, and where the cache lives.

    Under ``auto`` the candidate is chosen only from a measurement it won,
    fresh or cached for this device kind, key and kernel revision.
    ``measure_pair`` returns ``(candidate_ms, baseline_ms)``.
    ``eligibility`` is the client's static check: a workload the kernel
    cannot run takes the baseline before the card is asked (forced ``on``
    bypasses it)."""
    if mode not in MODES:
        raise ValueError(f"{client} mode must be one of {MODES}, got "
                         f"{mode!r}")
    cand, base = names
    out = {"kernel": base, "mode": mode, "source": "platform", "key": key,
           f"{cand}_ms": None, f"{base}_ms": None, "margin": None,
           "cache_hit": False}

    if mode in ("on", "off"):
        out["kernel"] = cand if mode == "on" else base
        out["source"] = "forced"
        return out

    if eligibility is not None and not eligibility[0]:
        out["source"] = "ineligible"
        out["reason"] = eligibility[1]
        return out

    if platform is None:
        platform = ACCELERATOR if torch.cuda.is_available() else "cpu"
    out["platform"] = platform
    if platform != ACCELERATOR:
        return out

    if device_kind is None:
        device_kind = card_kind()
    out["device_kind"] = device_kind
    rev = kernel_rev()
    out["kernel_rev"] = rev
    path = cache_path(client, device_kind, cache_dir)
    out["cache_path"] = path
    cache = load_cache(path)
    entry = cache["entries"].get(key)
    if entry and entry.get("kernel_rev") == rev:
        out.update(kernel=entry["kernel"], source="cache", cache_hit=True,
                   margin=entry.get("margin"),
                   measured_at=entry.get("measured_at"))
        out[f"{cand}_ms"] = entry.get(f"{cand}_ms")
        out[f"{base}_ms"] = entry.get(f"{base}_ms")
        return out

    cand_ms, base_ms = measure_pair()
    # A strict win: a tie keeps the baseline.
    winner = cand if cand_ms < base_ms else base
    loser_ms = max(cand_ms, base_ms)
    margin = (loser_ms - min(cand_ms, base_ms)) / loser_ms if loser_ms \
        else 0.0
    out.update(kernel=winner, source="measured", margin=round(margin, 4),
               measured_at=_now_iso())
    out[f"{cand}_ms"] = round(cand_ms, 4)
    out[f"{base}_ms"] = round(base_ms, 4)
    cache["device_kind"] = device_kind
    cache["entries"][key] = {
        "kernel": winner, f"{cand}_ms": out[f"{cand}_ms"],
        f"{base}_ms": out[f"{base}_ms"], "margin": out["margin"],
        "kernel_rev": rev, "measured_at": out["measured_at"],
    }
    try:
        save_cache(path, cache)
    except OSError:
        out["cache_path"] = None
        seed_local(path, key, cache["entries"][key])
    return out


def lookup(client: str, key: str, *, candidate: str,
           kernel_rev: Callable[[], int],
           cache_dir: Optional[str] = None,
           platform: Optional[str] = None,
           device_kind: Optional[str] = None) -> bool:
    """Whether ``key`` runs the candidate, from the platform and the cache
    only: no entry (nobody measured) means the plain side."""
    if platform is None:
        platform = ACCELERATOR if torch.cuda.is_available() else "cpu"
    if platform != ACCELERATOR:
        return False
    if device_kind is None:
        device_kind = card_kind()
    path = cache_path(client, device_kind, cache_dir)
    entry = (load_cache(path)["entries"].get(key)
             or _local_entries.get((path, key)))
    return bool(entry and entry.get("kernel_rev") == kernel_rev()
                and entry.get("kernel") == candidate)


def shared_decision(decide_fn: Callable[[], dict], *,
                    what: str = "dispatch") -> dict:
    """One decision for the whole data-parallel gang. Timings taken on
    each rank are noisy: at a near tie two ranks could pick different
    kernels, and the replicas would then step differently. So rank 0
    decides and the process group (its host channel) carries the decision
    to every other rank, which adopts it (``shared_from_primary``). A
    probe that raises on rank 0 is carried too: every rank then raises.
    Without a process group of two or more ranks this is ``decide_fn()``.
    Every rank must call it at the same point."""
    from tpudist_torch import dist as dist_lib
    rank, world = dist_lib.data_rank_world()
    if world == 1:
        return decide_fn()
    if rank == 0:
        try:
            dec = decide_fn()
        except Exception as e:
            dist_lib.broadcast_object({"failed": repr(e)[:500]})
            raise
        dist_lib.broadcast_object(dec)
        return dec
    dec = dist_lib.broadcast_object(None)
    if dec.get("failed"):
        raise RuntimeError(f"rank 0's {what} probe failed: {dec['failed']}")
    return dict(dec, shared_from_primary=1)
