"""The host-side EWMA loss-spike detector: the port's copy of
``tpudist/doctor/monitor.py`` (host math, line for line).

The in-step sentinel catches NaN and inf; this monitor catches the finite
failures (a poisoned batch, a diverging learning rate, a corrupting card
whose logits drift) by tracking an exponentially weighted mean and
variance of the drained loss and flagging a step whose loss sits more than
``sigma`` deviations above the mean. It reads values the metric drain
already brought to the host, one step late, so the hot loop pays nothing.
"""

from __future__ import annotations

import math
from typing import Optional


class LossMonitor:
    """EWMA mean/variance spike detector.

    ``sigma``: flag when ``loss > mean + sigma * std``. ``min_steps``:
    warmup observations before any flag can fire (the first epoch's
    rapidly-falling loss would otherwise read as volatility). ``decay``:
    EWMA decay for both moments. ``rel_floor``: a floor on std as a
    fraction of the mean — a run whose loss has converged to a near-flat
    line must not flag ordinary batch noise just because its measured
    variance approaches zero.
    """

    def __init__(self, sigma: float = 6.0, min_steps: int = 8,
                 decay: float = 0.9, rel_floor: float = 0.05):
        if sigma <= 0:
            raise ValueError(f"sigma must be > 0, got {sigma}")
        self.sigma = float(sigma)
        self.min_steps = max(1, int(min_steps))
        self.decay = float(decay)
        self.rel_floor = float(rel_floor)
        self.reset()

    def reset(self) -> None:
        """Forget history (post-rollback: the replayed window must warm up
        fresh, not be judged against the poisoned run's statistics)."""
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    def observe(self, loss: float) -> Optional[dict]:
        """Feed one drained loss value; returns spike info (the evidence
        for the telemetry event) or None. Non-finite losses are the
        in-step sentinel's jurisdiction and are ignored here — they never
        poison the EWMA statistics."""
        loss = float(loss)
        if not math.isfinite(loss):
            return None
        if self.mean is None:
            self.mean = loss
            self.n = 1
            return None
        std = math.sqrt(max(self.var, (self.rel_floor * abs(self.mean)) ** 2))
        spike = (self.n >= self.min_steps
                 and loss > self.mean + self.sigma * std)
        if spike:
            # Do NOT absorb the spike into the statistics: a rollback
            # follows, and the replay is judged against the healthy curve.
            return {"loss": round(loss, 6), "mean": round(self.mean, 6),
                    "std": round(std, 6),
                    "sigmas": round((loss - self.mean) / max(std, 1e-12), 2)}
        d = loss - self.mean
        self.mean += (1.0 - self.decay) * d
        self.var = self.decay * (self.var + (1.0 - self.decay) * d * d)
        self.n += 1
        return None
