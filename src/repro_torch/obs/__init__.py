"""Observability: trace shards, one metrics registry, and the cluster's
journal, watchdog, live metrics and leak audit.

Copies of the reference's ``repro.obs.{trace,metrics,journal,watch,live,
leakcheck}``; the shard, snapshot and ``CLUSTER_LOG.jsonl`` formats are the
same, so the reference's reporter and readers read what the port writes.
Tracing and metrics are off (and free) until enabled.
"""
