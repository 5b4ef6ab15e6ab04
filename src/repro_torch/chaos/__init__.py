"""Chaos: journaled fault injection for soak runs (the reference's
``repro.chaos``, framework-free, copied).

* :mod:`repro_torch.chaos.faults` — cross-process fault *arming*: sentinel
  files under ``$CRUM_CHAOS_DIR`` that in-tree shims (the store writer's
  quota, the heartbeat's clock skew) poll. One environment lookup when the
  variable is unset.
* :mod:`repro_torch.chaos.injectors` — the injection engine: every
  injection is first a ``crum-inject/1`` line in ``INJECT_LOG.jsonl`` (with
  its expected evidence) and a trace instant, and only then the fault.
* :mod:`repro_torch.chaos.schedule` + :mod:`repro_torch.chaos.soak` — a
  seeded schedule (the same seed gives the reference's plan) and the driver
  (``python -m repro_torch.chaos.soak``) that runs a cluster under it.

The verdict is :mod:`repro_torch.obs.soak`. The formats are the
reference's, so either package's verdict reads either package's run.
"""
from repro_torch.chaos.faults import CHAOS_ENV, active, arm, disarm
from repro_torch.chaos.injectors import (
    INJECT_SCHEMA,
    ClusterHandles,
    InjectionEngine,
)
from repro_torch.chaos.schedule import PlannedInjection, build_schedule

__all__ = [
    "CHAOS_ENV",
    "arm",
    "disarm",
    "active",
    "INJECT_SCHEMA",
    "ClusterHandles",
    "InjectionEngine",
    "PlannedInjection",
    "build_schedule",
]
