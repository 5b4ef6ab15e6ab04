"""Coordination wire format: u32-length-prefixed MessagePack frames.

Only the framing of the reference's ``repro.coord`` is ported so far (the
device proxy speaks it); the coordinator, workers and supervisor come with
the cluster slice of the port.
"""
