"""Edge<->cloud communication boundary (PyTorch counterpart of
:mod:`dart_planner_tpu.comms`, the same wire format).

The whole plan->control stack runs in one process, so these transports
survive only as the *system boundary*: talking to a remote edge box, ground
station, or demo UI. Semantics mirror the reference ``communication/``
package: ZMQ REQ/REP with HMAC-SHA256-signed JSON (+TTL), a heartbeat
monitor with emergency callback, and gzip/binary telemetry compression.
A message or telemetry packet of either package is read by the other.
"""

from dart_planner_tpu_torch.comms.serializer import SecureSerializer, serialize, deserialize
from dart_planner_tpu_torch.comms.zmq_transport import ZmqClient, ZmqServer
from dart_planner_tpu_torch.comms.heartbeat import (
    HeartbeatConfig,
    HeartbeatMessage,
    HeartbeatMonitor,
)
from dart_planner_tpu_torch.comms.telemetry import (
    CompressionType,
    TelemetryCompressor,
    TelemetryPacket,
)

__all__ = [
    "SecureSerializer",
    "serialize",
    "deserialize",
    "ZmqClient",
    "ZmqServer",
    "HeartbeatConfig",
    "HeartbeatMessage",
    "HeartbeatMonitor",
    "CompressionType",
    "TelemetryCompressor",
    "TelemetryPacket",
]
