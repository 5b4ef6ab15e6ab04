"""Observability: per-process trace shards and one metrics registry.

Copies of the reference's ``repro.obs.trace`` and ``repro.obs.metrics``;
the shard and snapshot formats are the same, so the reference's reporter
reads what the port writes. Both are off (and free) until enabled.
"""
