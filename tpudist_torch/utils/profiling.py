"""Step-window profiler: the port's copy of ``tpudist/utils/profiling.py``
over ``torch.profiler``.

``StepProfiler`` captures a trace for a configured step window
(``--profile start:end``, tpudist's grammar: ``parse_window``): it starts
the profiler when the global step enters the window and stops it when the
step leaves it, at the end of an epoch (validation and checkpoints stay
out of the capture; a window that runs on into the next epoch starts a
fresh trace there) and at exit. Each capture is one Chrome trace,
``<outpath>/profile/attempt_<n>/steps<first>-<last>.pt.trace.json``
(``n`` is the launcher's restart counter, so a relaunch keeps the
previous attempt's capture), readable in Perfetto and
``chrome://tracing``.

It records CPU activity and, on the card, CUDA activity (the kernels,
copies and their launches); under ``--device cuda`` a torch build whose
profiler cannot record CUDA activity is an error, never a CPU-only trace.
On the card the window's edges wait for the card (``synchronize``), so
the capture holds the device work of its own steps and of no other. The
trainer labels the capture with ``record_function`` ranges: ``train``
around each step, ``tpudist.data_wait``, ``tpudist.h2d`` and
``tpudist.metric_drain``.

``Capture`` is one such trace, started and stopped by step: the
``StepProfiler``'s windows and the flight recorder's one-shot deep
capture (``blackbox.py``) both take it. torch has one profiler a
process: a capture does not start while another is recording (the
``--profile`` window keeps the profiler; the recorder then keeps its
dump and skips the trace, as tpudist's does).
"""

from __future__ import annotations

import os
from typing import Optional


def parse_window(spec: str) -> Optional[tuple[int, int]]:
    """'10:20' → (10, 20); '15' → (15, 16); '' → None (off)."""
    if not spec:
        return None
    if ":" in spec:
        a, b = spec.split(":", 1)
        start, end = int(a), int(b)
    else:
        start, end = int(spec), int(spec) + 1
    if end <= start:
        raise ValueError(f"empty profile window '{spec}' (need end > start)")
    return start, end


def profiler_recording() -> bool:
    """True while a torch profiler records in this process."""
    import torch
    return bool(torch._C._autograd._profiler_enabled())


class Capture:
    """One ``torch.profiler`` trace into ``logdir``: ``start(first)``
    (False when another profiler records), ``note(step)`` for each step
    it holds, ``stop()`` writes ``steps<first>-<last>.pt.trace.json`` and
    returns its path. On the card its edges wait for the card."""

    def __init__(self, logdir: str, cuda: bool):
        self.logdir = logdir
        self.cuda = cuda
        self.active = False
        self._prof = None
        self.first = self.last = 0

    def start(self, first: int) -> bool:
        import torch
        import torch.profiler as tp
        if profiler_recording():
            return False
        activities = [tp.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(tp.ProfilerActivity.CUDA)
            torch.cuda.synchronize()     # earlier steps' work stays out
        os.makedirs(self.logdir, exist_ok=True)
        self._prof = tp.profile(activities=activities)
        self._prof.__enter__()
        self.active = True
        self.first = self.last = first
        return True

    def note(self, step: int) -> None:
        self.last = step

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        import torch
        if self.cuda:
            torch.cuda.synchronize()     # the capture's own work is all in
        self._prof.__exit__(None, None, None)
        self.active = False
        path = os.path.join(self.logdir,
                            f"steps{self.first}-{self.last}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path


class StepProfiler:
    """Trace global steps in [start, end). Call ``step(global_step)`` once
    per training step, before it is dispatched; ``epoch_end()`` after an
    epoch's last step; ``close()`` at exit."""

    def __init__(self, spec: str, logdir: str, enabled: bool = True,
                 device=None):
        from tpudist_torch.telemetry import env_attempt
        self.window = parse_window(spec) if enabled else None
        self.logdir = os.path.join(logdir, "profile",
                                   f"attempt_{env_attempt()}")
        self.cuda = getattr(device, "type", device) == "cuda"
        self._capture = Capture(self.logdir, self.cuda)
        if self.window is not None and self.cuda:
            import torch.profiler as tp
            if tp.ProfilerActivity.CUDA not in tp.supported_activities():
                raise RuntimeError(
                    "--profile on the card: this torch's profiler cannot "
                    "record CUDA activity (supported: "
                    f"{sorted(a.name for a in tp.supported_activities())})")

    @property
    def active(self) -> bool:
        return self._capture.active

    def step(self, global_step: int) -> None:
        if self.window is None:
            return
        start, end = self.window
        if not self.active and start <= global_step < end:
            self._capture.start(global_step)
        elif self.active and global_step >= end:
            self.close()
        if self.active:
            self._capture.note(global_step)

    def epoch_end(self) -> None:
        """Stop an open trace at the epoch boundary, so validation and the
        checkpoint never enter the capture."""
        self.close()

    def close(self) -> None:
        self._capture.stop()
