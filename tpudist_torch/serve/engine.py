"""``ServeEngine`` — a warmed bucket set and bucketed eval inference.

Counterpart of ``tpudist/serve/engine.py``. PyTorch runs eagerly, so
there is no AOT compile; its counterpart is one forward per bucket at
startup, each emitting ``compile`` with ``phase="serve_aot"``: the first
call of each shape pays the one-time costs (kernel library load and
build, cuBLAS/cuDNN plan choice, allocator growth) before traffic
arrives. Every later call lands on one of those bucket shapes, because
``infer`` chunks and pads into them.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from tpudist_torch._device import resolve_device
from tpudist_torch.serve.batching import pad_to_bucket, pick_bucket


class ServeEngine:
    """Eval-mode inference over a fixed bucket set.

    ``infer(images)`` accepts any row count: it chunks to the largest
    bucket, pads each chunk to its bucket shape, runs the model on the
    device, and returns the valid rows' logits as one host float32 array.
    ``last_info`` describes the bucket calls the most recent ``infer``
    made (the batcher's ``serve_batch`` event source).
    """

    def __init__(self, model: torch.nn.Module, *, image_size: int,
                 buckets: Sequence[int] = (1, 2, 4, 8), device=None,
                 telemetry=None, log=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.image_size = int(image_size)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.telemetry = telemetry
        self._log = log
        self.aot_s = 0.0                    # warm-up wall of the bucket set
        self.last_info: list[dict] = []
        self._warmup()

    def _forward(self, padded: np.ndarray) -> np.ndarray:
        """Logits of one bucket-shaped batch; the copy to the host waits
        for the device."""
        with torch.inference_mode():
            x = torch.from_numpy(padded).to(self.device)
            return self.model(x).float().cpu().numpy()

    # -- warm-up: one forward per bucket -----------------------------------
    def _warmup(self) -> None:
        tel = self.telemetry
        t_all = time.perf_counter()
        for b in self.buckets:
            t0 = time.perf_counter()
            self._forward(np.zeros((b, self.image_size, self.image_size, 3),
                                   np.float32))
            if tel is not None:
                tel.note_compile(time.perf_counter() - t0, phase="serve_aot",
                                 bucket=b)
        self.aot_s = time.perf_counter() - t_all
        if self._log is not None:
            self._log(f"=> serve warm-up: {len(self.buckets)} bucket shapes "
                      f"{list(self.buckets)} in {self.aot_s:.2f}s on "
                      f"{self.device}")
        if tel is not None:
            tel.emit("serve_start", n_buckets=len(self.buckets),
                     aot_s=round(self.aot_s, 6),
                     aot_compile_s=round(self.aot_s, 6), cache="off",
                     buckets=",".join(str(b) for b in self.buckets),
                     image_size=self.image_size,
                     arch=type(self.model).__name__)

    # -- steady-state inference --------------------------------------------
    def infer(self, images: np.ndarray) -> np.ndarray:
        """Logits for ``images`` (``(n, H, W, C)`` float32, any n ≥ 1).
        Blocks until the result is host-resident."""
        images = np.asarray(images, dtype=np.float32)
        n = images.shape[0]
        if n < 1:
            raise ValueError("infer needs at least one row")
        max_b = self.buckets[-1]
        outs: list[np.ndarray] = []
        info: list[dict] = []
        i = 0
        while i < n:
            chunk = images[i:i + max_b]
            valid = chunk.shape[0]
            bucket = pick_bucket(valid, self.buckets)
            padded = pad_to_bucket(chunk, bucket)
            t0 = time.perf_counter()
            host = self._forward(padded)
            info.append({"bucket": bucket, "n_valid": valid,
                         "seconds": time.perf_counter() - t0})
            outs.append(host[:valid])
            i += valid
        self.last_info = info
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
