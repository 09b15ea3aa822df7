"""MBTA vehicles poller (reference: mbta_to_kafka.py, whole file).

A copy of ``heatmap_tpu/producers/mbta.py``; ``requests`` is imported only
where a live session is built (``fetch`` without an injected session).

Behavioral parity:
- GET https://api-v3.mbta.com/vehicles with a fields filter and
  page[limit]=200 (mbta_to_kafka.py:41-48), optional x-api-key header (:19-21).
- requests.Session with Retry(total=3, backoff 0.5, on 429/5xx) (:23-27).
- speed m/s → km/h via ×3.6, only for numeric speeds (:70); wall-clock ts
  fallback when updated_at is absent OR not Z-suffixed (:64,73); malformed
  vehicles skipped with a warning (:75-77).
- vehicleId prefers the vehicle label, then the id, then "unknown" (:69).
- canonical 8-field event, key = vehicleId.
"""

from __future__ import annotations

import datetime as dt
import logging

log = logging.getLogger(__name__)

MBTA_URL = "https://api-v3.mbta.com/vehicles"
FIELDS = "latitude,longitude,speed,bearing,updated_at,label"


def utcnow_iso() -> str:
    return dt.datetime.now(dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class MbtaProducer:
    provider = "mbta"

    def __init__(self, api_key: str = "", page_limit: int = 200,
                 session=None):
        self.session = session  # a live one is built at the first fetch
        self.headers = {"x-api-key": api_key} if api_key else {}
        self.page_limit = page_limit

    @staticmethod
    def _make_session():
        import requests
        from requests.adapters import HTTPAdapter
        from urllib3.util.retry import Retry

        s = requests.Session()
        retry = Retry(total=3, backoff_factor=0.5,
                      status_forcelist=(429, 500, 502, 503, 504))
        s.mount("https://", HTTPAdapter(max_retries=retry))
        return s

    def fetch(self) -> list[dict]:
        if self.session is None:
            self.session = self._make_session()
        resp = self.session.get(
            MBTA_URL,
            params={"fields[vehicle]": FIELDS,
                    "page[limit]": str(self.page_limit)},
            headers=self.headers,
            timeout=10,
        )
        resp.raise_for_status()
        return self.to_events(resp.json())

    def to_events(self, payload: dict) -> list[dict]:
        out = []
        for item in payload.get("data", []):
            try:
                attrs = item.get("attributes") or {}  # null attrs -> skip
                lat = attrs.get("latitude")
                lon = attrs.get("longitude")
                if lat is None or lon is None:
                    continue
                speed_ms = attrs.get("speed")
                ts = attrs.get("updated_at") or utcnow_iso()
                if not isinstance(ts, str):
                    # ref hits AttributeError at ts.endswith and skips the
                    # vehicle as malformed (:73)
                    raise TypeError(f"updated_at: {ts!r}")
                if not ts.endswith("Z"):
                    # ref replaces non-Z-suffixed timestamps with wall clock
                    ts = utcnow_iso()
                out.append({
                    "provider": self.provider,
                    # unwrapped like the ref (:68): a numeric label goes
                    # into the JSON as a number; only the Kafka KEY is
                    # str()'d (producers/base.py, ref :79)
                    "vehicleId": (attrs.get("label") or item.get("id")
                                  or "unknown"),
                    "lat": float(lat),
                    "lon": float(lon),
                    "speedKmh": (float(speed_ms) * 3.6
                                 if isinstance(speed_ms, (int, float))
                                 else None),
                    "bearing": attrs.get("bearing"),
                    "accuracyM": None,
                    "ts": ts,
                })
            except (TypeError, ValueError) as e:
                log.warning("skipping malformed vehicle %s: %s",
                            item.get("id"), e)
        return out


def main():  # pragma: no cover - needs network
    import logging as _l
    import os

    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.producers.base import make_publisher, run_poll_loop

    _l.basicConfig(level=_l.INFO,
                   format="%(asctime)s %(levelname)s %(message)s")
    cfg = load_config()
    prod = MbtaProducer(os.environ.get("MBTA_API_KEY", ""))
    pub = make_publisher(cfg)
    run_poll_loop(prod.fetch, pub, period_s=3.0)  # ref poll period (:84)


if __name__ == "__main__":  # pragma: no cover
    main()
