"""sink — storage writers with the reference's MongoDB document contracts.

A copy of ``heatmap_tpu/sink/__init__.py``: the ``tiles`` and
``positions_latest`` collections behind one ``Store`` interface (memory,
JSONL, MongoDB over pymongo or the stdlib wire client), the ``AsyncWriter``
thread that overlaps store I/O with the device fold, and ``make_store``,
which ``HEATMAP_STORE`` drives.
"""

from heatmap_tpu_torch.sink.base import Store  # noqa: F401
from heatmap_tpu_torch.sink.jsonl import JsonlStore  # noqa: F401
from heatmap_tpu_torch.sink.memory import MemoryStore  # noqa: F401
from heatmap_tpu_torch.sink.writer import AsyncWriter  # noqa: F401


def make_store(cfg, writer: bool = True) -> Store:
    """Store factory honoring HEATMAP_STORE (auto | memory | jsonl | mongo):
    jsonl writes ``<checkpoint_dir>/store.jsonl``; mongo connects to
    ``mongo_uri``/``mongo_db``; auto takes Mongo when a server answers at
    ``mongo_uri``, else the in-memory store (the reference's documented
    behaviour).

    Under ``HEATMAP_SHARDS`` > 1 the jsonl log is per shard, since the
    log has one writer (its close compacts the file from that process's
    view): a shard writer gets ``<checkpoint_dir>/shard<i>/store.jsonl``,
    the namespace its checkpoints use, and ``writer=False`` (a serve-only
    process) loads the union of every shard's log."""
    kind = cfg.store
    if kind == "memory":
        return MemoryStore()
    if kind == "jsonl":
        directory = cfg.checkpoint_dir
        if cfg.shards > 1:
            if writer:
                return JsonlStore(f"{directory}/shard{cfg.shard_index}")
            return JsonlStore(directory, merge_shard_logs=True)
        return JsonlStore(directory)
    from heatmap_tpu_torch.sink.mongo import MongoStore

    if kind == "mongo":
        return MongoStore(cfg.mongo_uri, cfg.mongo_db)
    try:
        return MongoStore(cfg.mongo_uri, cfg.mongo_db)
    except Exception as e:
        # ImportError / OSError / WireError and pymongo's
        # ServerSelectionTimeoutError (neither OSError nor RuntimeError):
        # any unreachable-server shape degrades to memory
        import logging

        logging.getLogger(__name__).warning(
            "mongo unavailable (%s: %s); using in-memory store",
            type(e).__name__, e)
        return MemoryStore()
