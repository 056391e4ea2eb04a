"""The doctor (``--doctor``): the port's copy of ``tpudist/doctor/``.

- Sentinels (``train.make_train_step(guard=True)``): finiteness of the
  mean loss and of the global gradient norm, taken on the card after the
  gradients' reduction; a tripped sentinel undoes the whole update
  (parameters, optimizer state, BN running statistics, EMA) by a select
  on the card, and the flags reach the host through the one-step-late
  metric drain.
- Loss-spike detection (``monitor.LossMonitor``): an EWMA mean and
  variance over the drained losses.
- SDC probes (``probes``): every ``--doctor-probe-freq`` steps each rank
  digests its replicated state and compares the digests through the run
  dir.
- Policies (``policy.Doctor``): audit the skip, roll back to the newest
  probe-verified-good checkpoint and replay the epoch minus the poisoned
  window, evict a repeat SDC offender (exit 76).
"""

from tpudist_torch.doctor.monitor import LossMonitor            # noqa: F401
from tpudist_torch.doctor.policy import Doctor, RollbackRequested  # noqa: F401
