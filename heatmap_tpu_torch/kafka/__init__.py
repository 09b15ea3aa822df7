"""Kafka wire-protocol client over stdlib sockets (no client library).

A copy of ``heatmap_tpu/kafka`` with its Python paths only:

- ``protocol`` — primitive codecs + request/response framing
- ``records``  — RecordBatch v2 encode/decode with CRC32C
- ``client``   — broker client: metadata, produce, fetch, list_offsets,
                 with per-partition leader routing and version negotiation

No consumer groups: as in the reference, per-partition offsets are
committed through the runtime's checkpoint (``stream.checkpoint``), not
the broker, so replay after a crash is exact.
"""

from heatmap_tpu_torch.kafka.client import (  # noqa: F401
    BrokerClient, FetchResult, KafkaClient, KafkaError,
)
from heatmap_tpu_torch.kafka.records import (  # noqa: F401
    Record, decode_batches, decode_batches_tolerant, encode_batch,
)
