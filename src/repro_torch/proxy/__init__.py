"""Device-proxy subsystem (paper §3): compute in a restartable proxy process.

The application process stays "device-clean" — it never owns device state,
only a host mirror — while a separate proxy process owns the card and
executes the pipelined step stream. Every state-creating call is appended
to a durable API log, so a killed proxy is respawned and replayed to the
last synced step with bit-identical results, and restart re-creates device
state by replaying the logged allocations and pushing the data back
(RestoreManager's ``restore_into_proxy``).
"""
from repro_torch.proxy.api_log import ApiLog, iter_records
from repro_torch.proxy.client import DeviceProxy
from repro_torch.proxy.programs import (
    StepProgram,
    list_step_programs,
    make_program,
    register_step_program,
)
from repro_torch.proxy.protocol import ProxyDiedError, ProxyServiceConfig
from repro_torch.proxy.segments import (
    PrivateTable,
    SegmentTable,
    SharedSegment,
    StateTable,
    default_segment_dir,
)
from repro_torch.proxy.supervisor import ProxyRunner

__all__ = [
    "ApiLog", "iter_records",
    "DeviceProxy", "ProxyDiedError", "ProxyServiceConfig",
    "StateTable", "PrivateTable",
    "SegmentTable", "SharedSegment", "default_segment_dir",
    "StepProgram", "make_program", "register_step_program",
    "list_step_programs",
    "ProxyRunner",
]
