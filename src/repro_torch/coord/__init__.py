"""Cluster coordination — CRUM's DMTCP-coordinator layer, on the card.

CRUM checkpoints a *cluster*: a central coordinator quiesces every rank,
each rank's forked child persists its share of the image, and a single
commit makes the checkpoint visible atomically across all ranks. This
package is that layer, with ranks as real OS processes (the reference's
``repro.coord``, ported):

  protocol.py     length-prefixed MessagePack frames + message vocabulary
                  (JOIN/HEARTBEAT/READY/DRAIN/PERSIST_DONE/COMMIT/ABORT/…)
  coordinator.py  membership, heartbeat-gated two-phase commit (hostmetas
                  are prepare records, the merged MANIFEST + COMMIT marker
                  is the decision), abort on death/stall, round journal
  worker.py       the per-rank loop: train on the card, barrier at
                  checkpoint boundaries, persist own shards (card views,
                  digested on the card) via ForkedCheckpointer in
                  external-commit mode, failure injection for drills
  supervisor.py   restart supervision: spawn N ranks, reap deaths, respawn
                  with restore-from-latest-committed so the cluster
                  converges back to lockstep

Entry points: ``python -m repro_torch.launch.cluster --hosts 4 ...`` and
:func:`run_cluster`.
"""
from repro_torch.coord.protocol import (
    MSG_ABORT,
    MSG_COMMIT,
    MSG_DRAIN,
    MSG_FINISHED,
    MSG_HEARTBEAT,
    MSG_JOIN,
    MSG_PERSIST_DONE,
    MSG_PERSIST_FAIL,
    MSG_READY,
    MSG_SHUTDOWN,
    MSG_WELCOME,
    Connection,
    recv_frame,
    send_frame,
)
from repro_torch.coord.coordinator import Coordinator, RoundRecord
from repro_torch.coord.worker import WorkerConfig, worker_entry
from repro_torch.coord.supervisor import ClusterReport, ClusterSupervisor, run_cluster

__all__ = [
    "Connection", "send_frame", "recv_frame",
    "MSG_JOIN", "MSG_WELCOME", "MSG_HEARTBEAT", "MSG_READY", "MSG_DRAIN",
    "MSG_PERSIST_DONE", "MSG_PERSIST_FAIL", "MSG_COMMIT", "MSG_ABORT",
    "MSG_FINISHED", "MSG_SHUTDOWN",
    "Coordinator", "RoundRecord",
    "WorkerConfig", "worker_entry",
    "ClusterSupervisor", "ClusterReport", "run_cluster",
]
