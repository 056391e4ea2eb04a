"""Continuous batching: an open-loop request queue packed into
bucket-padded micro-batches.

The port's copy of ``tpudist/serve/batching.py``, with the same semantics
and the same telemetry events:

- ``pick_bucket`` quantizes a request-batch size to the smallest
  configured bucket that fits (the largest bucket caps one engine call —
  oversize batches chunk);
- ``pad_to_bucket`` zero-pads the rows up to the bucket (eval-mode
  forward passes are row-independent, so padding rows cannot perturb the
  valid rows' logits; pinned by test);
- ``ContinuousBatcher`` pulls every queued request (waiting up to
  ``max_wait_s`` for stragglers), concatenates up to the largest bucket's
  rows, runs ONE engine call, scatters the results back to each request's
  future, and accounts per-request latency and batch occupancy;
- ``open_loop_load`` is the synthetic traffic source (Poisson arrivals at
  a target rate, submission independent of completion).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np


def parse_buckets(spec) -> tuple[int, ...]:
    """'1,2,4,8' (or an int sequence) → sorted unique positive bucket
    sizes. At least one bucket; zero/negative entries are config errors."""
    if isinstance(spec, str):
        vals = [int(tok) for tok in spec.replace(",", " ").split()]
    else:
        vals = [int(v) for v in spec]
    if not vals or any(v <= 0 for v in vals):
        raise ValueError(f"buckets must be positive ints, got {spec!r}")
    return tuple(sorted(set(vals)))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket ≥ n, else the largest (callers chunk oversize
    batches down to it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_to_bucket(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad rows up to ``bucket`` (no-op at exact fit). Oversize input
    is a caller bug — the engine chunks BEFORE padding."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError(f"batch of {n} rows exceeds bucket {bucket} — "
                         f"chunk before padding")
    pad = np.zeros((bucket - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class ServeResult:
    """One request's future: ``wait()`` blocks until the batcher scatters
    the logits back; latency is stamped submit → result-ready."""

    __slots__ = ("images", "n", "t_submit", "latency_s", "value", "error",
                 "_done")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.n = int(images.shape[0])
        self.t_submit = time.time()
        self.latency_s: Optional[float] = None
        self.value: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def _set(self, value=None, error=None) -> None:
        self.value = value
        self.error = error
        self.latency_s = time.time() - self.t_submit
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("serve request did not complete in time")
        if self.error is not None:
            raise self.error
        return self.value


class ContinuousBatcher:
    """The serving loop: queue → coalesce → one bucketed engine call →
    scatter. Single consumer thread (one device pipeline); thread-safe
    ``submit`` from any number of producers.

    Telemetry (optional): a ``serve_batch`` event per bucket call the
    engine made and a ``request`` event per completed request (error=1 on
    a failed one), plus a self-throttled heartbeat.
    """

    def __init__(self, engine, max_wait_s: float = 0.002, telemetry=None):
        self.engine = engine
        self.max_wait_s = max(0.0, float(max_wait_s))
        self.telemetry = telemetry
        self.n_requests = 0
        self.n_batches = 0
        self.n_errors = 0
        self._q: deque[ServeResult] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="tpudist-torch-serve-batcher",
                                        daemon=True)
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def submit(self, images: np.ndarray) -> ServeResult:
        """Enqueue one request (``(n, H, W, C)`` float32 rows); returns its
        future. Raises after ``close()``."""
        req = ServeResult(np.asarray(images))
        with self._cv:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            self._q.append(req)
            self._cv.notify()
        return req

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    # -- consumer loop -----------------------------------------------------
    def _gather(self) -> tuple[list[ServeResult], int]:
        """Pull the next micro-batch: block for the first request, then
        coalesce more up to the largest bucket's rows, waiting at most
        ``max_wait_s`` for stragglers. Returns ``([], 0)`` at shutdown."""
        max_rows = self.engine.buckets[-1]
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return [], 0
            batch = [self._q.popleft()]
            rows = batch[0].n
            deadline = time.monotonic() + self.max_wait_s
            while rows < max_rows:
                if self._q:
                    if rows + self._q[0].n > max_rows:
                        break
                    nxt = self._q.popleft()
                    batch.append(nxt)
                    rows += nxt.n
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cv.wait(remaining)
            return batch, len(self._q)

    def _loop(self) -> None:
        tel = self.telemetry
        while True:
            batch, depth = self._gather()
            if not batch:
                return
            images = (batch[0].images if len(batch) == 1 else
                      np.concatenate([r.images for r in batch], axis=0))
            t0 = time.perf_counter()
            try:
                out = self.engine.infer(images)
                err = None
            except Exception as e:          # scatter the failure, keep serving
                out, err = None, e
            batch_s = time.perf_counter() - t0
            offset = 0
            for req in batch:
                if err is not None:
                    req._set(error=err)
                else:
                    req._set(value=out[offset:offset + req.n])
                offset += req.n
            self.n_requests += len(batch)
            info = self.engine.last_info if err is None else []
            self.n_batches += max(1, len(info)) if err is None else 0
            if err is not None:
                self.n_errors += len(batch)
            if tel is not None:
                if err is None:
                    tel.productive_s += batch_s
                    for j, call in enumerate(info):
                        tel.emit("serve_batch", bucket=call["bucket"],
                                 n_valid=call["n_valid"],
                                 batch_s=round(call["seconds"], 6),
                                 queue_depth=depth,
                                 **({"n_requests": len(batch)} if j == 0
                                    else {}))
                for req in batch:
                    tel.emit("request", latency_s=round(req.latency_s, 6),
                             n_images=req.n,
                             **({"error": 1} if err is not None else {}))
                tel.beat(self.n_batches)

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain what is queued, join the loop."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        if self.telemetry is not None:
            self.telemetry.beat(self.n_batches)


def open_loop_load(batcher: ContinuousBatcher, rate_hz: float,
                   duration_s: float,
                   make_images: Callable[[np.random.Generator], np.ndarray],
                   seed: int = 0,
                   wait_timeout_s: float = 120.0) -> list[ServeResult]:
    """Synthetic OPEN-LOOP traffic: Poisson arrivals at ``rate_hz`` for
    ``duration_s``, submission times scheduled independently of
    completions. Returns every request's completed future. Engine errors
    complete a request with ``.error`` set; only a request that never
    completes raises (TimeoutError)."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    results: list[ServeResult] = []
    t0 = time.monotonic()
    t_next = t0
    while t_next - t0 < duration_s:
        now = time.monotonic()
        if now < t_next:
            time.sleep(t_next - now)
        results.append(batcher.submit(make_images(rng)))
        t_next += rng.exponential(1.0 / rate_hz)
    for r in results:
        if not r._done.wait(wait_timeout_s):
            raise TimeoutError("serve request did not complete in time")
    return results
