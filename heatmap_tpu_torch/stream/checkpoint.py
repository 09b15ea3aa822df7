"""Offsets + state checkpoints, in the on-disk format of
``heatmap_tpu/stream/checkpoint.py``.

Every commit writes a fresh ``commit-<epoch>/`` directory holding
``meta.json`` (source offset, watermark high-ts, epoch, shard count, the
snap route that keyed the state), one ``state-<res>-<win_s>.npz`` per
(resolution, window) pair with the 13 ``TileState`` fields, key words as
uint32 (the layout the port's ``to_host`` gives and ``from_host`` takes),
and one ``extra-<name>.npz`` per named extras payload (the inference
engine's entity table, ``extra-infer.npz``).
The directory is written as ``commit-<epoch>.tmp`` and renamed whole, then
the single ``LATEST`` pointer file is replaced atomically, so a crash at
any point leaves ``LATEST`` naming a complete older commit: offsets and
state are never torn against each other.  Older commits are pruned to
``KEEP_COMMITS``.  A commit either package writes resumes in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np

from heatmap_tpu_torch.engine.state import TileState

KEEP_COMMITS = 2  # current + previous, for post-mortem debugging


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.latest_path = os.path.join(directory, "LATEST")

    def _commit_dir(self, epoch: int | None = None) -> str | None:
        if epoch is not None:
            path = os.path.join(self.dir, f"commit-{epoch:012d}")
            return path if os.path.isdir(path) else None
        if not os.path.exists(self.latest_path):
            return None
        with open(self.latest_path, encoding="utf-8") as fh:
            name = fh.read().strip()
        path = os.path.join(self.dir, name)
        return path if os.path.isdir(path) else None

    def available_epochs(self) -> list[int]:
        """Epochs with a complete retained commit dir (ascending)."""
        out = []
        for n in sorted(os.listdir(self.dir)) if os.path.isdir(self.dir) else []:
            if n.startswith("commit-") and not n.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, n, "meta.json")):
                    out.append(int(n[len("commit-"):]))
        return out

    # --- read -----------------------------------------------------------
    def load_meta(self, epoch: int | None = None) -> dict | None:
        """The latest commit's meta, or a retained epoch's."""
        d = self._commit_dir(epoch)
        if d is None:
            return None
        with open(os.path.join(d, "meta.json"), encoding="utf-8") as fh:
            return json.load(fh)

    def load_state(self, res: int, win: int,
                   epoch: int | None = None) -> TileState | None:
        """One pair's host state (numpy, key words uint32), or None."""
        d = self._commit_dir(epoch)
        if d is None:
            return None
        path = os.path.join(d, f"state-{res}-{win}.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            missing = [k for k in TileState._fields if k not in z.files]
            if missing:
                # an older layout held ABSOLUTE sums without the per-group
                # anchors; synthesizing them would corrupt every resumed
                # average, so refuse loudly
                raise ValueError(
                    f"checkpoint {path} was written by an older state "
                    f"layout (missing {missing}); it cannot be resumed by "
                    f"this version — restart from empty state (the sink "
                    f"is idempotent) or replay with the writing version")
            return TileState(**{k: z[k] for k in TileState._fields})

    def load_extra(self, name: str, epoch: int | None = None) -> dict | None:
        """A named extras payload committed beside the state
        (``extra-<name>.npz``), or None when the commit has none."""
        d = self._commit_dir(epoch)
        if d is None:
            return None
        path = os.path.join(d, f"extra-{name}.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    # --- write ----------------------------------------------------------
    def commit(self, offset: Any, max_event_ts: int, epoch: int,
               states: dict[tuple[int, int], TileState] | None = None,
               shards: int | None = None,
               snap_impl: str | None = None,
               extras: dict[str, dict] | None = None) -> None:
        """``states``: host states by (res, window_s).  ``shards``: the
        writer's shard-block count, so a restart can tell a capacity change
        (absorbable) from a shard-count change (refused).  ``snap_impl``:
        the snap route that keyed the state.  ``extras``: named auxiliary
        payloads ({name: {key: array}}), reducer state that rides the same
        atomic commit as the window state it must stay consistent with."""
        name = f"commit-{epoch:012d}"
        cdir = os.path.join(self.dir, name)
        tmp = cdir + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for (res, win), st in (states or {}).items():
            np.savez(os.path.join(tmp, f"state-{res}-{win}.npz"),
                     **{k: np.asarray(v) for k, v in st._asdict().items()})
        for ename, payload in (extras or {}).items():
            np.savez(os.path.join(tmp, f"extra-{ename}.npz"),
                     **{k: np.asarray(v) for k, v in payload.items()})
        meta = {"offset": offset, "max_event_ts": int(max_event_ts),
                "epoch": int(epoch)}
        if shards is not None:
            meta["shards"] = int(shards)
        if snap_impl is not None:
            meta["snap_impl"] = snap_impl
        with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
        shutil.rmtree(cdir, ignore_errors=True)
        os.replace(tmp, cdir)

        # the atomic pointer flip
        ptmp = self.latest_path + ".tmp"
        with open(ptmp, "w", encoding="utf-8") as fh:
            fh.write(name)
        os.replace(ptmp, self.latest_path)
        self._prune(keep=name)

    def _prune(self, keep: str) -> None:
        commits = sorted(
            n for n in os.listdir(self.dir)
            if n.startswith("commit-") and not n.endswith(".tmp")
        )
        for n in commits[:-KEEP_COMMITS]:
            if n != keep:
                shutil.rmtree(os.path.join(self.dir, n), ignore_errors=True)
