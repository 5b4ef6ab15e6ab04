"""Observability: trace shards, one metrics registry, and the cluster's
journal, watchdog, live metrics and leak audit; the run-dir reporter, the
critical-path analysis and the soak verdict.

Copies of the reference's ``repro.obs.{trace,metrics,journal,watch,live,
leakcheck,report,critpath,soak}``; the shard, snapshot, ``CLUSTER_LOG.jsonl``,
``INJECT_LOG.jsonl`` and ``soak.json`` formats are the same, so either
package's readers read what the other writes. One departure: ``leakcheck``
counts the ``/dev/shm`` entries of its own run, not the machine's. Tracing
and metrics are off (and free) until enabled.
"""
