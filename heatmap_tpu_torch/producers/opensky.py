"""OpenSky aircraft-states poller.

A copy of ``heatmap_tpu/producers/opensky.py`` (OpenSky ``/states/all``, no
API key, global aircraft; BASELINE.json config #2); ``requests`` is
imported only where a live session is built (``fetch`` without an
injected session).

OpenSky state vectors are positional arrays:
  [0] icao24, [1] callsign, [5] longitude, [6] latitude,
  [9] velocity (m/s), [10] true_track (deg), [3] time_position (epoch s).
"""

from __future__ import annotations

import datetime as dt
import logging

log = logging.getLogger(__name__)

OPENSKY_URL = "https://opensky-network.org/api/states/all"


class OpenSkyProducer:
    provider = "opensky"

    def __init__(self, bbox: tuple[float, float, float, float] | None = None,
                 session=None):
        """bbox = (lamin, lomin, lamax, lomax) or None for global; a live
        session is built at the first fetch unless one is injected."""
        self.bbox = bbox
        self.session = session

    @staticmethod
    def _make_session():
        import requests
        from requests.adapters import HTTPAdapter
        from urllib3.util.retry import Retry

        s = requests.Session()
        retry = Retry(total=3, backoff_factor=1.0,
                      status_forcelist=(429, 500, 502, 503, 504))
        s.mount("https://", HTTPAdapter(max_retries=retry))
        return s

    def fetch(self) -> list[dict]:
        if self.session is None:
            self.session = self._make_session()
        params = {}
        if self.bbox:
            params = dict(zip(("lamin", "lomin", "lamax", "lomax"),
                              (str(v) for v in self.bbox)))
        resp = self.session.get(OPENSKY_URL, params=params, timeout=20)
        resp.raise_for_status()
        return self.to_events(resp.json())

    def to_events(self, payload: dict) -> list[dict]:
        out = []
        now = payload.get("time")
        for sv in payload.get("states") or []:
            try:
                lon, lat = sv[5], sv[6]
                if lat is None or lon is None:
                    continue
                t = sv[3] if sv[3] is not None else now
                ts = (
                    dt.datetime.fromtimestamp(t, dt.timezone.utc)
                    .strftime("%Y-%m-%dT%H:%M:%SZ")
                    if t is not None else None
                )
                vel = sv[9]
                callsign = (sv[1] or "").strip()
                out.append({
                    # icao24 alone is the stable identity; callsigns appear/
                    # change between polls and would fork positions_latest docs
                    "provider": self.provider,
                    "vehicleId": str(sv[0]),
                    "callsign": callsign or None,
                    "lat": float(lat),
                    "lon": float(lon),
                    "speedKmh": float(vel) * 3.6 if vel is not None else None,
                    "bearing": sv[10],
                    "accuracyM": None,
                    "ts": ts,
                })
            except (IndexError, TypeError, ValueError) as e:
                log.warning("skipping malformed state vector: %s", e)
        return out


def main():  # pragma: no cover - needs network
    import logging as _l

    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.producers.base import make_publisher, run_poll_loop

    _l.basicConfig(level=_l.INFO,
                   format="%(asctime)s %(levelname)s %(message)s")
    cfg = load_config()
    prod = OpenSkyProducer()
    pub = make_publisher(cfg)
    run_poll_loop(prod.fetch, pub, period_s=10.0)


if __name__ == "__main__":  # pragma: no cover
    main()
