"""producers — live-feed pollers publishing canonical GPS events.

A copy of ``heatmap_tpu/producers``: the MBTA vehicles poller (the
reference's ``mbta_to_kafka.py``), the OpenSky aircraft-states poller and
the publishers they write to (``Publisher``: Kafka over the port's wire
client in the json, binary or columnar event format, a JSONL capture that
``stream.source.JsonlReplaySource`` replays, or an in-process queue).

Importing this package needs no ``requests``: it is imported where a live
HTTP session is built (``MbtaProducer.fetch`` / ``OpenSkyProducer.fetch``
without an injected session) and by ``run_poll_loop`` for its network
error tiers.  ``python -m heatmap_tpu_torch.producers.mbta`` (or
``.opensky``) runs a live poller into the Kafka topic of ``KAFKA_BOOTSTRAP``
/ ``KAFKA_TOPIC`` (a JSONL capture when no broker answers).
"""

from heatmap_tpu_torch.producers.base import (  # noqa: F401
    JsonlPublisher,
    KafkaPublisher,
    MemoryPublisher,
    Publisher,
    make_publisher,
    run_poll_loop,
)
from heatmap_tpu_torch.producers.mbta import MbtaProducer  # noqa: F401
from heatmap_tpu_torch.producers.opensky import OpenSkyProducer  # noqa: F401
