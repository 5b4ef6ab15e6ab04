"""The data-plane transport axis of the device proxy, and proxy placement.

``transport``: shared-segment (local, zero-copy) vs streamed
(length-prefixed dirty-chunk frames over the proxy's TCP connection).
``placement``: the coordinator's endpoint registry and least-loaded
assignment (``PlacementMap``) and the rank side of the PROXY_ENDPOINT
handshake (``CoordEndpointProvider``, a ``ProxyRunner(endpoint_provider=...)``).
``host``: the proxy-host daemon, a process that serves proxy sessions for
any number of remote applications over TCP.
"""
from repro_torch.remote.host import ProxyHostConfig, ProxyHostHandle, serve_forever
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
    "ProxyHostConfig",
    "ProxyHostHandle",
    "serve_forever",
    "ChunkTransport",
    "SegmentChunkTransport",
    "StreamChunkTransport",
    "make_transport",
]
