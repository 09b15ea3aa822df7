"""Columnar batch event values (``HEATMAP_EVENT_FORMAT=columnar``).

A copy of ``heatmap_tpu/stream/colfmt.py``.  One Kafka record value
carries N events in struct-of-arrays form plus a batch-local string table.
Decoding is numpy views over the value bytes plus one intern pass over the
(small) string table; the LUT cache skips the intern pass when producers
resend the same vehicle set.  The string table's entry offsets come from
the C++ parser (``native.strtab_offsets_native``) by default, or from the
Python loop, its plain version, when the caller passes ``native=False``.

Layout (little-endian), after the 16-byte header:

    u8   magic    = 0xB2
    u8   version  = 1
    u16  flags    = 0 (reserved)
    u32  n              events in the batch
    u32  n_strings      entries in the batch string table
    u32  strtab_bytes   byte length of the string-table blob
    f32  lat[n]         degrees
    f32  lon[n]         degrees
    f32  speed[n]       km/h
    f32  bearing[n]
    f32  accuracy[n]
    i64  ts[n]          epoch seconds
    u32  provider_id[n] index into the batch string table
    u32  vehicle_id[n]  index into the batch string table
    string table: per entry u16 byte length + UTF-8 bytes, concatenated

Validation semantics on decode match parse_events exactly (vectorized):
rows with out-of-range lat/lon/ts, non-finite coordinates, or ids past
the string table are dropped and counted; non-finite speed becomes 0.

Trade-off vs per-event keying by vehicleId: a batch value cannot be partitioned by vehicleId, so columnar publishers
spread batches round-robin.  The aggregation re-shards by (cell, window)
on device and the positions fold is a per-vehicle max-ts guard — both
order- and partition-insensitive — so affinity is not load-bearing in
this framework.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xB2
VERSION = 1
_HEAD = struct.Struct("<BBHIII")
HEADER_SIZE = _HEAD.size  # 16
# sentinel key for the session bytes->str memo stashed inside the
# caller-owned lut_cache (cannot collide with the (blob, n) tuple keys)
_BYTES_MEMO_KEY = ("__strtab_bytes_memo__",)

from heatmap_tpu_torch.stream.events import EventColumns, parse_ts  # noqa: E402

_D2R = np.float32(np.pi / 180.0)


def encode_batch(events) -> bytes:
    """Canonical event dicts -> one columnar batch value.

    Events missing required fields or with unparseable ts are skipped
    (producers validate upstream; this mirrors binfmt.encode_event's
    strictness without failing the whole batch)."""
    lat, lon, speed, bearing, acc, ts = [], [], [], [], [], []
    pid, vid = [], []
    strings: dict[str, int] = {}

    def fnum(v):
        try:
            v = float(v) if v is not None else 0.0
        except (TypeError, ValueError):
            return 0.0
        return v if np.isfinite(v) else 0.0

    for e in events:
        try:
            la, lo = float(e["lat"]), float(e["lon"])
            if e["provider"] is None or e["vehicleId"] is None:
                continue  # parse_events drops null identities
            provider = str(e["provider"])
            vehicle = str(e["vehicleId"])
        except (KeyError, TypeError, ValueError):
            continue
        t = parse_ts(e.get("ts"))
        # skip what i64 can't carry — one poison ts must never wedge the
        # publisher's whole retry buffer
        if t is None or not np.isfinite(t) or not (-2**62 <= t < 2**62):
            continue
        lat.append(la)
        lon.append(lo)
        speed.append(fnum(e.get("speedKmh")))
        bearing.append(fnum(e.get("bearing")))
        acc.append(fnum(e.get("accuracyM")))
        ts.append(int(t))
        pid.append(strings.setdefault(provider, len(strings)))
        vid.append(strings.setdefault(vehicle, len(strings)))

    n = len(lat)
    # canonicalize the table: ids above were assigned first-seen, so the
    # SAME name set arriving in a different row order (live pollers,
    # rotating replay windows) would produce a different blob record
    # after record, defeating the decoder's blob-keyed LUT cache, whose
    # misses cost a ~5k-name Python parse + re-intern per record.  Sorted
    # names make the blob a pure function of the name SET, so steady-state
    # decode does no per-string work at all.
    order = sorted(range(len(strings)), key=list(strings).__getitem__)
    remap = np.empty(max(len(strings), 1), "<u4")
    remap[np.asarray(order, np.int64)] = np.arange(len(order), dtype="<u4")
    names = sorted(strings)
    tab = _encode_strtab(names)
    pid_arr = remap[np.asarray(pid, np.int64)] if pid else \
        np.zeros(0, "<u4")
    vid_arr = remap[np.asarray(vid, np.int64)] if vid else \
        np.zeros(0, "<u4")
    head = _HEAD.pack(MAGIC, VERSION, 0, n, len(strings), len(tab))
    return b"".join([
        head,
        np.asarray(lat, "<f4").tobytes(),
        np.asarray(lon, "<f4").tobytes(),
        np.asarray(speed, "<f4").tobytes(),
        np.asarray(bearing, "<f4").tobytes(),
        np.asarray(acc, "<f4").tobytes(),
        np.asarray(ts, "<i8").tobytes(),
        pid_arr.astype("<u4", copy=False).tobytes(),
        vid_arr.astype("<u4", copy=False).tobytes(),
        tab,
    ])


def encode_batch_columns(cols: EventColumns) -> bytes:
    """EventColumns -> one columnar batch value, array-native.

    The high-rate path for replay/backfill producers: no per-event
    Python.  Assumes the rows are already validated (they came from
    parse_events / a decoder).  Only the strings this batch actually
    references go on the wire (ids are remapped compactly) — session
    intern tables are cumulative, and embedding them whole would grow
    every record with vehicle churn until the broker rejects it."""
    n = len(cols)
    pid_in = np.asarray(cols.provider_id, np.int64)
    vid_in = np.asarray(cols.vehicle_id, np.int64)
    if n and (pid_in.min() < 0 or pid_in.max() >= len(cols.providers)
              or vid_in.min() < 0 or vid_in.max() >= len(cols.vehicles)):
        # silent whole-batch drops at decode are worse than failing here
        raise ValueError("provider_id/vehicle_id out of string-table range")
    up = np.unique(pid_in) if n else np.zeros(0, np.int64)
    uv = np.unique(vid_in) if n else np.zeros(0, np.int64)
    strings = ([str(cols.providers[i]) for i in up]
               + [str(cols.vehicles[i]) for i in uv])
    remap_p = np.zeros(int(up[-1]) + 1 if len(up) else 1, "<u4")
    remap_p[up] = np.arange(len(up), dtype="<u4")
    remap_v = np.zeros(int(uv[-1]) + 1 if len(uv) else 1, "<u4")
    remap_v[uv] = np.arange(len(uv), dtype="<u4") + np.uint32(len(up))
    pid = remap_p[pid_in]
    vid = remap_v[vid_in]
    tab = _encode_strtab(strings)
    zeros = np.zeros(n, "<f4")
    head = _HEAD.pack(MAGIC, VERSION, 0, n, len(strings), len(tab))
    return b"".join([
        head,
        cols.lat_deg.astype("<f4", copy=False).tobytes(),
        cols.lng_deg.astype("<f4", copy=False).tobytes(),
        cols.speed_kmh.astype("<f4", copy=False).tobytes(),
        zeros.tobytes(),   # bearing (not carried in EventColumns)
        zeros.tobytes(),   # accuracy
        cols.ts_s.astype("<i8").tobytes(),
        pid.tobytes(),
        vid.tobytes(),
        tab,
    ])


def _encode_strtab(strings) -> bytes:
    """String table blob: per entry u16 byte length + UTF-8 bytes."""
    parts = []
    for s in strings:
        b = s.encode("utf-8")[:0xFFFF]
        parts.append(struct.pack("<H", len(b)))
        parts.append(b)
    return b"".join(parts)


def _parse_strtab(blob: bytes, n_strings: int,
                  bytes_memo: dict | None = None,
                  native: bool = True) -> list[str] | None:
    """Strtab blob -> list of strings; None when an entry runs past the
    blob.

    ``bytes_memo`` (session-lifetime, caller-owned) maps raw utf-8
    entries to their decoded strings: producers resend mostly the same
    names record after record but with drifting record boundaries the
    whole-blob memo in decode_batch misses.  A bytes-key dict hit skips
    the decode (and reuses the one str object, which also makes the
    downstream intern setdefault a pointer-compare hit).  With ``native``
    the entry offsets come from the C++ one-pass parser (decoder.cpp
    cf_strtab_offsets; a toolchain that cannot build raises); without, from
    the per-entry struct.unpack_from loop, its plain version."""
    offs = None
    if native:
        from heatmap_tpu_torch.native import strtab_offsets_native

        try:
            offs, lens = strtab_offsets_native(blob, n_strings)
        except ValueError:  # entry runs past the blob: same reject below
            return None
        offs, lens = offs.tolist(), lens.tolist()
    out = []
    memo_get = bytes_memo.get if bytes_memo is not None else None
    if offs is not None:
        for i in range(n_strings):
            o = offs[i]
            raw = blob[o:o + lens[i]]
            s = memo_get(raw) if memo_get is not None else None
            if s is None:
                s = raw.decode("utf-8", "replace")
                if bytes_memo is not None:
                    if len(bytes_memo) >= 1 << 20:  # unbounded-name safety
                        bytes_memo.clear()
                    bytes_memo[raw] = s
            out.append(s)
        return out
    off = 0
    for _ in range(n_strings):
        if off + 2 > len(blob):
            return None
        (ln,) = struct.unpack_from("<H", blob, off)
        off += 2
        if off + ln > len(blob):
            return None
        raw = blob[off:off + ln]
        s = memo_get(raw) if memo_get is not None else None
        if s is None:
            s = raw.decode("utf-8", "replace")
            if bytes_memo is not None:
                if len(bytes_memo) >= 1 << 20:
                    bytes_memo.clear()
                bytes_memo[raw] = s
        out.append(s)
        off += ln
    return out


def decode_batch(value: bytes, intern_p: dict, intern_v: dict,
                 lut_cache: dict | None = None,
                 extras: dict | None = None,
                 native: bool = True) -> EventColumns | None:
    """One columnar value -> EventColumns (session-interned ids).

    Returns None when the envelope (magic/version/lengths) is invalid;
    row-level validation drops rows into ``n_dropped`` exactly like
    parse_events.  ``lut_cache`` (owned by the caller, same lifetime as
    the intern maps) memoizes the string-table parse and the
    batch-id->session-id LUTs keyed by the table blob: producers resend
    the same vehicle set batch after batch, so the steady state does no
    per-string Python work at all.  ``extras``, when given, receives the
    wire columns EventColumns does not carry (``bearing``, ``accuracy``
    f32 arrays, row-filtered like the rest): the dict expansion uses this
    to report the encoded values instead of zeros.  ``native`` picks the
    string-table parser (``_parse_strtab``)."""
    if len(value) < HEADER_SIZE:
        return None
    magic, ver, _flags, n, n_strings, tab_bytes = _HEAD.unpack_from(value)
    if magic != MAGIC or ver != VERSION:
        return None
    body = n * (5 * 4 + 8 + 2 * 4)
    if len(value) != HEADER_SIZE + body + tab_bytes:
        return None
    off = HEADER_SIZE

    def arr(dtype, count):
        nonlocal off
        a = np.frombuffer(value, dtype, count, off)
        off += a.nbytes
        return a

    lat = arr("<f4", n)
    lon = arr("<f4", n)
    speed = arr("<f4", n)
    bearing = arr("<f4", n)   # unused by the device path (EventColumns
    accuracy = arr("<f4", n)  # drops them); surfaced via ``extras``
    ts = arr("<i8", n)
    pid = arr("<u4", n)
    vid = arr("<u4", n)
    blob = value[off:off + tab_bytes]
    # key includes n_strings: the same blob under a different claimed count
    # parses (or fails) differently, and a hit must never skip the
    # envelope rejection the uncached path guarantees
    key = (blob, n_strings)
    cached = lut_cache.get(key) if lut_cache is not None else None
    if cached is None:
        bytes_memo = (lut_cache.setdefault(_BYTES_MEMO_KEY, {})
                      if lut_cache is not None else None)
        strings = _parse_strtab(blob, n_strings, bytes_memo, native)
        if strings is None:
            return None
        # role-split LUTs, filled lazily as ids are seen in each role
        cached = (strings, np.full(max(n_strings, 1), -1, np.int32),
                  np.full(max(n_strings, 1), -1, np.int32))
        if lut_cache is not None:
            if len(lut_cache) >= 128:  # bounded: vehicle churn makes new blobs
                lut_cache.clear()
            lut_cache[key] = cached
    strings, lut_p, lut_v = cached

    # vectorized validation, parse_events semantics
    ok = (
        np.isfinite(lat) & np.isfinite(lon)
        & (lat >= -90.0) & (lat <= 90.0)
        & (lon >= -180.0) & (lon <= 180.0)
        & (ts >= 0) & (ts < 2**31)
        & (pid < n_strings) & (vid < n_strings)
    )
    n_dropped = int(n - ok.sum())
    if n_dropped:
        lat, lon, speed = lat[ok], lon[ok], speed[ok]
        ts, pid, vid = ts[ok], pid[ok], vid[ok]
        if extras is not None:
            bearing, accuracy = bearing[ok], accuracy[ok]
    speed = np.where(np.isfinite(speed), speed, np.float32(0.0))
    if extras is not None:
        extras["bearing"] = bearing
        extras["accuracy"] = accuracy

    # batch-local string ids -> session intern ids, split by ROLE: only
    # strings actually referenced as providers enter the provider intern
    # map (and likewise vehicles), so the session tables stay clean.
    # Cached LUTs skip already-mapped ids (intern maps are grow-only, so
    # existing entries never invalidate).
    if len(pid):
        for i in np.unique(pid[lut_p[pid] < 0]):
            lut_p[i] = intern_p.setdefault(strings[i], len(intern_p))
    if len(vid):
        for i in np.unique(vid[lut_v[vid] < 0]):
            lut_v[i] = intern_v.setdefault(strings[i], len(intern_v))

    lat32 = lat.astype(np.float32, copy=False)
    lon32 = lon.astype(np.float32, copy=False)
    return EventColumns(
        lat_rad=lat32 * _D2R,
        lng_rad=lon32 * _D2R,
        lat_deg=lat32,
        lng_deg=lon32,
        speed_kmh=speed.astype(np.float32, copy=False),
        ts_s=ts.astype(np.int32),
        provider_id=lut_p[pid],
        vehicle_id=lut_v[vid],
        providers=list(intern_p),
        vehicles=list(intern_v),
        n_dropped=n_dropped,
    )


def concat_columns(parts: list[EventColumns], intern_p: dict,
                   intern_v: dict) -> EventColumns:
    """Concatenate batches that share the SAME session intern maps."""
    if len(parts) == 1:
        return parts[0]
    return EventColumns(
        lat_rad=np.concatenate([p.lat_rad for p in parts]),
        lng_rad=np.concatenate([p.lng_rad for p in parts]),
        lat_deg=np.concatenate([p.lat_deg for p in parts]),
        lng_deg=np.concatenate([p.lng_deg for p in parts]),
        speed_kmh=np.concatenate([p.speed_kmh for p in parts]),
        ts_s=np.concatenate([p.ts_s for p in parts]),
        provider_id=np.concatenate([p.provider_id for p in parts]),
        vehicle_id=np.concatenate([p.vehicle_id for p in parts]),
        providers=list(intern_p),
        vehicles=list(intern_v),
        n_dropped=sum(p.n_dropped for p in parts),
    )


def decode_batch_dicts(value: bytes) -> list[dict]:
    """One columnar value -> event dicts (the per-value decoder of the
    reference's confluent/kafka-python consumers, which the port does not
    have; the wire source consumes EventColumns directly and never pays
    this expansion)."""
    p_map: dict = {}
    v_map: dict = {}
    extras: dict = {}
    cols = decode_batch(value, p_map, v_map, extras=extras)
    if cols is None:
        return []
    providers = list(p_map)
    vehicles = list(v_map)
    return [{
        "provider": providers[int(cols.provider_id[i])],
        "vehicleId": vehicles[int(cols.vehicle_id[i])],
        "lat": float(cols.lat_deg[i]),
        "lon": float(cols.lng_deg[i]),
        "speedKmh": float(cols.speed_kmh[i]),
        "bearing": float(extras["bearing"][i]),
        "accuracyM": float(extras["accuracy"][i]),
        "ts": int(cols.ts_s[i]),
    } for i in range(len(cols))]
