"""The data-plane transport axis of the device proxy.

``transport`` is ported: shared-segment (local, zero-copy) vs streamed
(length-prefixed dirty-chunk frames over the proxy's TCP connection). The
reference's proxy-host daemon (``host``) and worker placement
(``placement``) are not ported yet; ``ProxyRunner(endpoint_provider=...)``
is the seam they plug into.
"""
from repro_torch.remote.transport import (
    ChunkTransport,
    SegmentChunkTransport,
    StreamChunkTransport,
    make_transport,
)

__all__ = [
    "ChunkTransport",
    "SegmentChunkTransport",
    "StreamChunkTransport",
    "make_transport",
]
