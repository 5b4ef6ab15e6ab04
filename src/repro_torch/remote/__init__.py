"""The data-plane transport axis of the device proxy, and proxy placement.

``transport``: shared-segment (local, zero-copy) vs streamed
(length-prefixed dirty-chunk frames over the proxy's TCP connection).
``placement``: the coordinator's endpoint registry and least-loaded
assignment (``PlacementMap``) and the rank side of the PROXY_ENDPOINT
handshake (``CoordEndpointProvider``, a ``ProxyRunner(endpoint_provider=...)``).
The reference's proxy-host daemon (``host``) is not ported yet.
"""
from repro_torch.remote.placement import (
    CoordEndpointProvider,
    PlacementMap,
    ProxyEndpoint,
)
from repro_torch.remote.transport import (
    ChunkTransport,
    SegmentChunkTransport,
    StreamChunkTransport,
    make_transport,
)

__all__ = [
    "CoordEndpointProvider",
    "PlacementMap",
    "ProxyEndpoint",
    "ChunkTransport",
    "SegmentChunkTransport",
    "StreamChunkTransport",
    "make_transport",
]
