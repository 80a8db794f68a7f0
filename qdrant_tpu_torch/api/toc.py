"""TableOfContent: the storage root owning all collections + aliases.

Reference: lib/storage/src/content_manager/toc/ (TableOfContent mod.rs:70,
collection_meta_ops.rs, alias mapping). Single-node dispatcher semantics
(reference: dispatcher.rs routes directly to ToC when no consensus is
configured); the cluster layer wraps this for distributed deployments.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

from ..collection.collection import Collection, CollectionError, NotFoundError
from ..types import (
    CollectionParams,
    HnswConfig,
    OptimizersConfig,
    StrictModeConfig,
    WalConfig,
    parse_vectors_config,
    SparseVectorParams,
)


def _remove_snapshot_file(full: str) -> None:
    """Remove a snapshot and its `.checksum` sidecar together — an orphaned
    sidecar would later fail a valid same-named snapshot's recovery."""
    if os.path.isfile(full):
        os.remove(full)
    sidecar = full + ".checksum"
    if os.path.isfile(sidecar):
        os.remove(sidecar)


def _list_snapshot_dir(target: str) -> List[Dict[str, Any]]:
    """Snapshot rows in `target`, with the `.checksum` sidecar when present."""
    out: List[Dict[str, Any]] = []
    if os.path.isdir(target):
        for f in sorted(os.listdir(target)):
            if f.endswith(".snapshot"):
                row: Dict[str, Any] = {
                    "name": f,
                    "size": os.path.getsize(os.path.join(target, f)),
                    "creation_time": None,
                }
                sidecar = os.path.join(target, f + ".checksum")
                if os.path.isfile(sidecar):
                    with open(sidecar) as cf:
                        row["checksum"] = cf.read().strip()
                out.append(row)
    return out


def _sha256_file(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_checksum(path: str) -> str:
    """Write the reference-style `<file>.checksum` sidecar → the digest."""
    digest = _sha256_file(path)
    with open(path + ".checksum", "w") as f:
        f.write(digest)
    return digest


class TableOfContent:
    def __init__(
        self,
        storage_path: str,
        flush_interval_sec: Optional[float] = None,
        snapshots_config: Optional[Dict[str, Any]] = None,
        quota_config: Optional[Dict[str, Any]] = None,
    ):
        self.storage_path = storage_path
        os.makedirs(storage_path, exist_ok=True)
        # node resource quotas (reference: lib/shard/src/quota/ — the
        # single measurement + enforcement point for memory/disk limits)
        from ..utils.quota import QuotaManager

        self.quota = QuotaManager(storage_path, quota_config)
        self.collections_path = os.path.join(storage_path, "collections")
        self.snapshots_path = os.path.join(storage_path, "snapshots")
        # remote snapshot mirror (reference: snapshots_manager.rs
        # SnapshotStorageCloud); local files stay as the working copy
        self.snapshot_store = None
        cfg = snapshots_config or {}
        if cfg.get("snapshots_storage") == "s3":
            from ..storage.object_store import S3SnapshotStorage

            self.snapshot_store = S3SnapshotStorage(cfg.get("s3_config") or {})
        os.makedirs(self.collections_path, exist_ok=True)
        os.makedirs(self.snapshots_path, exist_ok=True)
        # observability: slowest-request log + structured audit trail
        # (reference: profiling/slow_requests_log.rs, src/common/audit.rs)
        from ..utils.observability import AuditLog, SlowRequestsLog

        self.slow_log = SlowRequestsLog(
            max_entries=int(os.environ.get("QDRANT__SERVICE__SLOW_LOG_MAX", 16)),
            threshold_s=float(
                os.environ.get("QDRANT__SERVICE__SLOW_QUERY_SECS", 1.0)
            ),
        )
        self.audit_log = AuditLog(
            os.path.join(storage_path, "audit"),
            enabled=os.environ.get("QDRANT__SERVICE__AUDIT__ENABLED", "1")
            != "0",
            max_log_files=int(
                os.environ.get("QDRANT__SERVICE__AUDIT__MAX_LOG_FILES", 7)
            ),
        )
        self.collections: Dict[str, Collection] = {}
        self.aliases: Dict[str, str] = {}  # alias → collection name
        self._lock = threading.RLock()
        # with a flush thread present, optimizer work (seal/merge/vacuum)
        # moves off the write path onto that thread
        self._background_opt = bool(flush_interval_sec)
        self._load()
        # periodic flush (reference: storage.optimizers.flush_interval_sec)
        self._flush_stop = threading.Event()
        self._flush_thread = None
        if flush_interval_sec:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, args=(flush_interval_sec,), daemon=True
            )
            self._flush_thread.start()

    def _flush_loop(self, interval: float) -> None:
        while not self._flush_stop.wait(interval):
            try:
                self.flush_all()
            except Exception:
                pass  # a failed background flush must not kill the server
            try:
                self.optimize_all()
            except Exception:
                pass

    def _adopt(self, coll) -> None:
        coll.defer_optimizers = self._background_opt
        for shard in coll.shards.values():
            shard.defer_optimizers = self._background_opt

    def optimize_all(self) -> None:
        """One optimizer pass over every shard (seal/merge/vacuum). Runs on
        the background flush thread so index builds never stall writes
        (reference: update_handler.rs optimizer worker)."""
        for coll in list(self.collections.values()):
            for shard in list(coll.shards.values()):
                shard.maybe_optimize()

    # -- persistence of toc state -------------------------------------------

    def _aliases_file(self) -> str:
        return os.path.join(self.storage_path, "aliases.json")

    def _load(self) -> None:
        for name in sorted(os.listdir(self.collections_path)):
            path = os.path.join(self.collections_path, name)
            if os.path.isfile(os.path.join(path, "collection.json")):
                self.collections[name] = Collection.load(name, path)
                self._adopt(self.collections[name])
        if os.path.exists(self._aliases_file()):
            with open(self._aliases_file()) as f:
                self.aliases = json.load(f)

    def _save_aliases(self) -> None:
        with open(self._aliases_file(), "w") as f:
            json.dump(self.aliases, f)

    # -- collection management ----------------------------------------------

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self.collections.keys())

    def resolve_name(self, name: str) -> str:
        return self.aliases.get(name, name)

    def has_collection(self, name: str) -> bool:
        with self._lock:
            return self.resolve_name(name) in self.collections

    def get_collection(self, name: str) -> Collection:
        with self._lock:
            real = self.resolve_name(name)
            coll = self.collections.get(real)
            if coll is None:
                raise NotFoundError(f"Collection `{name}` doesn't exist!")
            return coll

    def create_collection(
        self,
        name: str,
        spec: Dict[str, Any],
        placement: Optional[Dict[int, list]] = None,
    ) -> bool:
        with self._lock:
            if name in self.collections or name in self.aliases:
                raise CollectionError(f"Collection `{name}` already exists!")
            params = CollectionParams(
                vectors=parse_vectors_config(spec.get("vectors")),
                sparse_vectors={
                    k: SparseVectorParams.from_dict(v or {})
                    for k, v in (spec.get("sparse_vectors") or {}).items()
                },
                shard_number=int(spec.get("shard_number", 1)),
                sharding_method=spec.get("sharding_method"),
                replication_factor=int(spec.get("replication_factor", 1)),
                write_consistency_factor=int(spec.get("write_consistency_factor", 1)),
                on_disk_payload=bool(spec.get("on_disk_payload", False)),
            )
            if not params.vectors and not params.sparse_vectors:
                raise CollectionError("collection must define vectors or sparse_vectors")
            node = getattr(self, "cluster_node", None)
            coll = Collection(
                name,
                os.path.join(self.collections_path, name),
                params,
                hnsw_config=HnswConfig.from_dict(spec.get("hnsw_config")),
                optimizers_config=OptimizersConfig.from_dict(spec.get("optimizers_config")),
                wal_config=WalConfig.from_dict(spec.get("wal_config")),
                strict_mode_config=StrictModeConfig.from_dict(
                    spec.get("strict_mode_config")
                ),
                placement=placement,
                this_peer_id=node.peer_id if node is not None else None,
            )
            self._adopt(coll)
            self.collections[name] = coll
            return True

    def update_collection(self, name: str, spec: Dict[str, Any]) -> bool:
        with self._lock:
            coll = self.get_collection(name)
            if spec.get("optimizers_config"):
                new = OptimizersConfig.from_dict(spec["optimizers_config"])
                coll.optimizers_config = new
                for shard in coll.shards.values():
                    shard.optimizers = new
            if spec.get("hnsw_config"):
                coll.hnsw_config = HnswConfig.from_dict(spec["hnsw_config"])
            if spec.get("strict_mode_config") is not None:
                import dataclasses as _dc

                cur = coll.strict_mode_config.to_dict()
                cur.update(spec["strict_mode_config"])
                coll.strict_mode_config = StrictModeConfig.from_dict(cur)
            coll.save_config()
            return True

    def delete_collection(self, name: str) -> bool:
        with self._lock:
            real = self.resolve_name(name)
            coll = self.collections.pop(real, None)
            if coll is None:
                return False
            coll.drop()
            self.aliases = {a: c for a, c in self.aliases.items() if c != real}
            self._save_aliases()
            return True

    # -- aliases -------------------------------------------------------------

    def update_aliases(self, actions: List[Dict[str, Any]]) -> bool:
        with self._lock:
            for action in actions:
                if "create_alias" in action:
                    spec = action["create_alias"]
                    cname = spec["collection_name"]
                    if cname not in self.collections:
                        raise NotFoundError(f"Collection `{cname}` doesn't exist!")
                    self.aliases[spec["alias_name"]] = cname
                elif "delete_alias" in action:
                    self.aliases.pop(action["delete_alias"]["alias_name"], None)
                elif "rename_alias" in action:
                    spec = action["rename_alias"]
                    old = spec["old_alias_name"]
                    if old not in self.aliases:
                        raise NotFoundError(f"Alias `{old}` doesn't exist!")
                    self.aliases[spec["new_alias_name"]] = self.aliases.pop(old)
                else:
                    raise CollectionError(f"unknown alias action: {action}")
            self._save_aliases()
            return True

    def collection_aliases(self, name: str) -> List[Dict[str, str]]:
        with self._lock:
            return [
                {"alias_name": a, "collection_name": c}
                for a, c in self.aliases.items()
                if c == name
            ]

    def all_aliases(self) -> List[Dict[str, str]]:
        with self._lock:
            return [
                {"alias_name": a, "collection_name": c} for a, c in self.aliases.items()
            ]

    # -- snapshots ------------------------------------------------------------

    def create_snapshot(self, name: str) -> Dict[str, Any]:
        coll = self.get_collection(name)
        target = os.path.join(self.snapshots_path, coll.name)
        fname = coll.create_snapshot(target)
        full = os.path.join(target, fname)
        checksum = _write_checksum(full)
        if self.snapshot_store is not None:
            self.snapshot_store.store(coll.name, fname, full)
        return {
            "name": fname,
            "size": os.path.getsize(full),
            "creation_time": None,
            "checksum": checksum,
        }

    def list_snapshots(self, name: str) -> List[Dict[str, Any]]:
        coll = self.get_collection(name)
        if self.snapshot_store is not None:
            return self.snapshot_store.list(coll.name)
        target = os.path.join(self.snapshots_path, coll.name)
        return _list_snapshot_dir(target)

    def delete_snapshot(self, name: str, snapshot: str) -> bool:
        coll = self.get_collection(name)
        full = os.path.join(self.snapshots_path, coll.name, snapshot)
        if self.snapshot_store is not None:
            self.snapshot_store.delete(coll.name, snapshot)
            if os.path.isfile(full):
                _remove_snapshot_file(full)
            return True
        if not os.path.isfile(full):
            raise NotFoundError(f"snapshot {snapshot} not found")
        _remove_snapshot_file(full)
        return True

    def recover_snapshot(
        self, name: str, snapshot_path: str, checksum: Optional[str] = None
    ) -> bool:
        # verify against the explicit checksum, or the sidecar written at
        # create time (reference: snapshots write <file>.checksum and
        # recovery validates it)
        expected = checksum
        sidecar = snapshot_path + ".checksum"
        if expected is None and os.path.isfile(sidecar):
            with open(sidecar) as f:
                expected = f.read().strip()
        if expected:
            digest = _sha256_file(snapshot_path)
            if digest != expected.lower():
                raise ValueError(
                    f"snapshot checksum mismatch: expected {expected}, "
                    f"got {digest}"
                )
        with self._lock:
            if name in self.collections:
                self.collections.pop(name).drop()
            target = os.path.join(self.collections_path, name)
            shutil.rmtree(target, ignore_errors=True)
            self.collections[name] = Collection.restore_snapshot(
                snapshot_path, name, target
            )
            return True

    # -- shard snapshots (public API; reference: src/tonic/mod.rs:138-338
    # ShardSnapshots service + src/actix/api/snapshot_api.rs shard routes) --

    def _shard(self, name: str, shard_id: int):
        coll = self.get_collection(name)
        shard = coll.shards.get(int(shard_id))
        if shard is None:
            raise NotFoundError(f"shard {shard_id} not found in {name}")
        return coll, shard

    def _shard_snapshots_dir(self, name: str, shard_id: int) -> str:
        coll = self.get_collection(name)
        return os.path.join(
            self.snapshots_path, coll.name, "shards", str(int(shard_id))
        )

    def create_shard_snapshot(self, name: str, shard_id: int) -> Dict[str, Any]:
        import time as _time

        coll, shard = self._shard(name, shard_id)
        target = self._shard_snapshots_dir(name, shard_id)
        os.makedirs(target, exist_ok=True)
        stamp = _time.strftime("%Y-%m-%d-%H-%M-%S")
        fname = f"{coll.name}-shard-{int(shard_id)}-{stamp}.snapshot"
        full = os.path.join(target, fname)
        with open(full, "wb") as f:
            f.write(shard.create_snapshot_bytes())
        checksum = _write_checksum(full)
        return {
            "name": fname,
            "size": os.path.getsize(full),
            "creation_time": None,
            "checksum": checksum,
        }

    def list_shard_snapshots(self, name: str, shard_id: int) -> List[Dict[str, Any]]:
        self._shard(name, shard_id)  # 404 on unknown collection/shard
        target = self._shard_snapshots_dir(name, shard_id)
        return _list_snapshot_dir(target)

    def delete_shard_snapshot(self, name: str, shard_id: int, snapshot: str) -> bool:
        self._shard(name, shard_id)
        full = os.path.join(self._shard_snapshots_dir(name, shard_id), snapshot)
        if not os.path.isfile(full):
            raise NotFoundError(f"snapshot {snapshot} not found")
        _remove_snapshot_file(full)
        return True

    def shard_snapshot_file(self, name: str, shard_id: int, snapshot: str) -> str:
        self._shard(name, shard_id)
        full = os.path.join(self._shard_snapshots_dir(name, shard_id), snapshot)
        if not os.path.isfile(full):
            raise NotFoundError(f"snapshot {snapshot} not found")
        return full

    def recover_shard_snapshot(
        self, name: str, shard_id: int, location: str, checksum: Optional[str] = None
    ) -> bool:
        """Restore one shard from a snapshot file: a local path, a name in
        this shard's snapshot dir, or an http(s)/file URL (reference:
        common/snapshots.rs::recover_shard_snapshot)."""
        coll, shard = self._shard(name, shard_id)
        data: Optional[bytes] = None
        if location.startswith(("http://", "https://")):
            import urllib.request

            with urllib.request.urlopen(location, timeout=60) as resp:
                data = resp.read()
        else:
            if location.startswith("file://"):
                location = location[len("file://") :]
            candidate = location
            if not os.path.isfile(candidate):
                candidate = os.path.join(
                    self._shard_snapshots_dir(name, shard_id), location
                )
            if not os.path.isfile(candidate):
                raise NotFoundError(f"shard snapshot {location} not found")
            with open(candidate, "rb") as f:
                data = f.read()
        if checksum:
            import hashlib

            digest = hashlib.sha256(data).hexdigest()
            if digest != checksum.lower():
                raise ValueError(
                    f"snapshot checksum mismatch: expected {checksum}, got {digest}"
                )
        return self.restore_shard_snapshot_bytes(name, shard_id, data)

    def restore_shard_snapshot_bytes(
        self, name: str, shard_id: int, data: bytes
    ) -> bool:
        coll, shard = self._shard(name, shard_id)
        shard.restore_snapshot_bytes(data)
        # drop any cached replica wrapper (clock map resets with the snapshot)
        cache = getattr(coll, "_local_replicas", None)
        if cache is not None:
            cache.pop(int(shard_id), None)
        return True

    def create_full_snapshot(self) -> Dict[str, Any]:
        """Full-storage snapshot: tar of every collection (reference:
        /snapshots full-storage API)."""
        import tarfile
        import time as _time

        self.flush_all()
        target = os.path.join(self.snapshots_path, "_full")
        os.makedirs(target, exist_ok=True)
        stamp = _time.strftime("%Y-%m-%d-%H-%M-%S")
        fname = f"full-snapshot-{stamp}.snapshot"
        full = os.path.join(target, fname)
        with tarfile.open(full, "w") as tar:
            tar.add(self.collections_path, arcname="collections")
            if os.path.exists(self._aliases_file()):
                tar.add(self._aliases_file(), arcname="aliases.json")
        return {
            "name": fname,
            "size": os.path.getsize(full),
            "creation_time": None,
            "checksum": _write_checksum(full),
        }

    def list_full_snapshots(self) -> List[Dict[str, Any]]:
        target = os.path.join(self.snapshots_path, "_full")
        return _list_snapshot_dir(target)

    def snapshot_file(self, collection: Optional[str], snapshot: str) -> str:
        sub = "_full" if collection is None else self.get_collection(collection).name
        full = os.path.join(self.snapshots_path, sub, snapshot)
        if self.snapshot_store is not None and not os.path.isfile(full):
            # pull the remote copy down to the local working dir
            os.makedirs(os.path.dirname(full), exist_ok=True)
            data = self.snapshot_store.retrieve(sub, snapshot)
            with open(full, "wb") as f:
                f.write(data)
        if not os.path.isfile(full):
            raise NotFoundError(f"snapshot {snapshot} not found")
        return full

    # -- lifecycle -----------------------------------------------------------

    def flush_all(self) -> None:
        with self._lock:
            for coll in self.collections.values():
                coll.flush()

    def close(self) -> None:
        self._flush_stop.set()
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=2)
        with self._lock:
            for coll in self.collections.values():
                coll.close()
