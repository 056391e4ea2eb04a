"""The detect→respond policy engine behind ``--doctor``: the port's copy
of ``tpudist/doctor/policy.py``.

One ``Doctor`` a rank, consulted by the trainer at step boundaries. In:
the drained step metrics (``on_metrics``, one step late: the guarded
step's ``notfinite``, ``gnorm`` and ``scaler_skip`` flags and the loss
for the EWMA monitor) and the periodic SDC probe (``probe``). Out, in
escalating order:

- **skip-step**: done on the card by the guarded step (the update was
  undone before the host saw the flag); the host audits it (a
  ``skip_step`` event) and escalates after ``--doctor-max-skips``
  consecutive skips (a float16 run's scaler overflows on a budget four
  times larger of their own);
- **rollback**: a loss spike (or persistent skipping) raises
  ``RollbackRequested`` at the next step boundary; the trainer restores
  the newest probe-verified-good checkpoint and replays the epoch minus
  the poisoned sample window;
- **evict**: a rank whose digest is minority-divergent in
  ``--doctor-sdc-windows`` consecutive probes ends with
  ``faults.SDC_EXIT_CODE`` (76), writing no checkpoint.

Each intervention is a ``doctor`` event and each probe an ``sdc_probe``
event, with tpudist's fields, so ``tpudist.summarize`` and the metrics
endpoint read a port run as they read tpudist's.
"""

from __future__ import annotations

from typing import Any, Optional

from tpudist_torch.doctor import probes
from tpudist_torch.doctor.monitor import LossMonitor


class RollbackRequested(Exception):
    """Raised at a step boundary when the doctor wants a rollback; carries
    the offending step and the evidence for the telemetry event."""

    def __init__(self, step: int, reason: str, info: Optional[dict] = None):
        super().__init__(f"{reason} at step {step}")
        self.step = step
        self.reason = reason
        self.info = dict(info or {})


class Doctor:
    """Per-rank policy engine. All host math; the only device access is
    the periodic probe's digest fetch (step-boundary, off the hot path)."""

    def __init__(self, cfg, outpath: str, rank: int, world: int,
                 telemetry=None, log=None, primary: bool = True):
        self.cfg = cfg
        self.outpath = outpath
        self.rank = rank
        self.world = max(1, int(world))
        self.telemetry = telemetry
        self.log = log or (lambda m: None)
        self.primary = primary
        self.monitor = LossMonitor(
            sigma=getattr(cfg, "doctor_spike_sigma", 6.0),
            min_steps=getattr(cfg, "doctor_spike_min_steps", 8))
        self.probe_freq = max(0, int(getattr(cfg, "doctor_probe_freq", 0)))
        self.max_skips = max(1, int(getattr(cfg, "doctor_max_skips", 5)))
        self.sdc_windows = max(1, int(getattr(cfg, "doctor_sdc_windows", 2)))
        # counters (summarize/obs read the telemetry stream; these back the
        # trainer's end-of-run log line and the rollback cap)
        self.skips = 0
        self.spikes = 0
        self.rollbacks = 0
        self.probes = 0
        self.divergences = 0
        self._consec_skips = 0
        self._skip_run_start: Optional[int] = None
        # fp16 scaler-skipped steps (overflow at the current loss scale):
        # the scaler's own jurisdiction, so they never count as doctor
        # skips — but data that is NaN at ANY scale overflows forever, so
        # a separate, larger budget (4x max_skips clears any honest
        # binary scale search: halving from the 2^16 default bottoms out
        # in ~16 steps) still escalates to the same rollback.
        self.max_scaler_skips = 4 * self.max_skips
        self._consec_scaler_skips = 0
        self._self_offenses = 0
        self._pending: Optional[RollbackRequested] = None
        # step → (epoch, global-sample start, end): the mapping a rollback
        # needs to turn "step s spiked" into "skip positions [a, b) of
        # epoch e's order". Small bounded host dict.
        self._positions: dict[int, tuple[int, int, int]] = {}

    # -- bookkeeping -------------------------------------------------------
    def _emit(self, etype: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(etype, **fields)

    def note_step(self, step: int, epoch: int, pos_start: int,
                  pos_end: int) -> None:
        """Record which global sample positions step ``step`` consumed."""
        self._positions[step] = (epoch, int(pos_start), int(pos_end))
        if len(self._positions) > 512:
            for k in sorted(self._positions)[:256]:
                del self._positions[k]

    def window_for(self, step: int) -> Optional[tuple[int, int, int]]:
        """(epoch, start, end) of the poisoned sample window around
        ``step``: the step's own positions (detection already lags one
        step, so the offending batch is exactly the flagged step's)."""
        return self._positions.get(step)

    def windows_for(self, rb: "RollbackRequested"
                    ) -> list[tuple[int, int, int]]:
        """Per-epoch merged (epoch, start, end) poison windows behind
        ``rb``. A loss spike poisons exactly the flagged step's batch; a
        ``persistent_nonfinite`` verdict poisons the WHOLE consecutive-
        skip run (``first_skip_step``..``step``) — excising only the last
        batch would replay straight into the remaining poisoned ones and
        burn one rollback per batch until the budget kills the run.
        Consecutive steps consume contiguous positions of one epoch pass,
        so the per-epoch union is a single merged window, in the same
        (pre-excision) coordinates ``window_for`` reports."""
        first = rb.info.get("first_skip_step")
        steps = (range(int(first), rb.step + 1) if first is not None
                 else (rb.step,))
        merged: dict[int, tuple[int, int]] = {}
        for s in steps:
            got = self._positions.get(s)
            if got is None:
                continue
            ep, a, b = got
            lo, hi = merged.get(ep, (a, b))
            merged[ep] = (min(lo, a), max(hi, b))
        return [(ep, a, b) for ep, (a, b) in sorted(merged.items())]

    # (The position ring deliberately survives epoch boundaries: a spike
    # detected in the epoch-end flush refers to a step of the epoch that
    # just closed, and global_step is monotonic across rollbacks, so keys
    # never alias.)

    # -- signal: drained metrics ------------------------------------------
    def on_metrics(self, step: int, vals: dict) -> None:
        """Fed by the metric drain (one step late, already host floats).
        Never raises — responses are delivered at step boundaries via
        ``check_response`` so they cannot fire mid-drain."""
        if vals.get("notfinite", 0.0) >= 0.5:
            self.skips += 1
            self._consec_skips += 1
            if self._consec_skips == 1:
                self._skip_run_start = step
            self.log(f"=> doctor: non-finite step {step} — update skipped "
                     f"in-program (consecutive {self._consec_skips})")
            self._emit("doctor", action="skip_step", step=step,
                       gnorm=_finite_or_none(vals.get("gnorm")),
                       loss=_finite_or_none(vals.get("loss")))
            if self._consec_skips >= self.max_skips \
                    and self._pending is None:
                self._pending = RollbackRequested(
                    step, "persistent_nonfinite",
                    {"consecutive_skips": self._consec_skips,
                     "first_skip_step": self._skip_run_start})
            return
        if vals.get("scaler_skip", 0.0) >= 0.5:
            self._consec_scaler_skips += 1
            if self._consec_scaler_skips == 1 \
                    and self._skip_run_start is None:
                self._skip_run_start = step
            if self._consec_scaler_skips >= self.max_scaler_skips \
                    and self._pending is None:
                self.log(f"=> doctor: {self._consec_scaler_skips} "
                         f"consecutive fp16 scaler overflows — no loss "
                         f"scale can make this data finite")
                self._pending = RollbackRequested(
                    step, "persistent_scaler_overflow",
                    {"consecutive_skips": self._consec_scaler_skips,
                     "first_skip_step": self._skip_run_start})
            return
        self._consec_skips = 0
        self._consec_scaler_skips = 0
        self._skip_run_start = None
        loss = vals.get("loss")
        if loss is None:
            return
        spike = self.monitor.observe(float(loss))
        if spike is not None:
            self.spikes += 1
            self.log(f"=> doctor: loss spike at step {step} — "
                     f"{spike['loss']:.4g} vs EWMA {spike['mean']:.4g} "
                     f"(+{spike['sigmas']}σ)")
            self._emit("doctor", action="spike", step=step, **spike)
            if self._pending is None:
                self._pending = RollbackRequested(step, "loss_spike", spike)

    def check_response(self) -> None:
        """Step-boundary consult: deliver a pending rollback decision."""
        if self._pending is not None:
            rb, self._pending = self._pending, None
            raise rb

    # -- signal: SDC probe -------------------------------------------------
    def should_probe(self, step: int) -> bool:
        return (self.probe_freq > 0 and step > 0
                and step % self.probe_freq == 0)

    def probe(self, step: int, state: Any) -> Optional[str]:
        """Digest-exchange-compare; stamp checkpoint verdicts; returns
        ``"evict"`` when THIS rank has been minority-divergent for
        ``--doctor-sdc-windows`` consecutive probes. ``state``: the
        ``(name, tensor)`` leaves (``probes.state_leaves``)."""
        from tpudist_torch import checkpoint as ckpt_lib
        digest = probes.replicated_digest(state)
        self.probes += 1
        if self.world > 1:
            probes.write_digest(self.outpath, self.rank, step, digest)
            # Bounded wait: a rank that died (or already self-quarantined)
            # never publishes — the probe judges whoever showed up instead
            # of stalling the survivors for long (the elastic plane owns
            # dead ranks).
            got = probes.collect_digests(self.outpath, step, self.world,
                                         timeout_s=20.0)
            probes.prune_digests(self.outpath,
                                 step - 2 * max(1, self.probe_freq))
        else:
            got = {self.rank: digest}
        divergent, tie = probes.divergent_ranks(got)
        self._emit("sdc_probe", step=step, world=len(got),
                   divergent=len(divergent), tie=int(tie),
                   ranks=",".join(str(r) for r in sorted(got)),
                   divergent_ranks=",".join(str(r) for r in divergent))
        if not divergent and not tie:
            self._self_offenses = 0
            if self.primary:
                # A clean probe at step t attests every checkpoint written
                # up to t: stamp the unstamped ones verified-good so the
                # rollback walk has somewhere trustworthy to land.
                ckpt_lib.stamp_outpath_verdicts(
                    self.outpath, ckpt_lib.VERDICT_GOOD, step)
            return None
        self.divergences += 1
        who = "unattributable (2-replica tie)" if tie \
            else f"rank(s) {divergent}"
        self.log(f"=> doctor: SDC probe at step {step} — replicated-state "
                 f"digest divergence, {who}")
        self._emit("doctor", action="sdc_divergence", step=step,
                   divergent=len(divergent), tie=int(tie),
                   divergent_ranks=",".join(str(r) for r in divergent))
        if self.primary:
            # Nothing written while the gang disagrees can be trusted.
            ckpt_lib.stamp_outpath_verdicts(
                self.outpath, ckpt_lib.VERDICT_SUSPECT, step)
        if self.rank in divergent:
            self._self_offenses += 1
            if self._self_offenses >= self.sdc_windows:
                self._emit("doctor", action="evict", step=step,
                           divergent_rank=self.rank,
                           windows=self._self_offenses)
                return "evict"
        else:
            self._self_offenses = 0
        return None

    # -- response: rollback bookkeeping ------------------------------------
    def on_rollback(self, rb: RollbackRequested, to_epoch: int,
                    windows: list[tuple[int, int, int]]) -> None:
        self.rollbacks += 1
        self._consec_skips = 0
        self._consec_scaler_skips = 0
        self._skip_run_start = None
        self.monitor.reset()
        fields = dict(action="rollback", step=rb.step, reason=rb.reason,
                      to_epoch=to_epoch, rollbacks=self.rollbacks)
        if windows:
            # First merged window flat (the common single-epoch case is
            # exact); multi-epoch spans additionally carry the count.
            fields.update(window_epoch=windows[0][0],
                          window_start=windows[0][1],
                          window_end=windows[0][2], windows=len(windows))
        self._emit("doctor", **fields)

    def summary(self) -> dict:
        return {"skips": self.skips, "spikes": self.spikes,
                "rollbacks": self.rollbacks, "probes": self.probes,
                "divergences": self.divergences}


def _finite_or_none(v):
    """Telemetry rejects non-finite floats; a NaN loss on a skip event is
    exactly the expected shape — carry it as absent, the flag is the
    signal."""
    import math
    if isinstance(v, (int, float)) and math.isfinite(v):
        return v
    return None
