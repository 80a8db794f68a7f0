"""Pop the LAST record off a WAL — the recovery tool for a poisoned tail
entry (reference: src/wal_pop.rs truncates the consensus WAL at
last_index).

Usage:
    python -m qdrant_tpu.tools.wal_pop <wal_dir>            # collection WAL
    python -m qdrant_tpu.tools.wal_pop <storage_dir> raft   # raft log
"""

from __future__ import annotations

import os
import sys


def pop_collection_wal(path: str) -> int:
    from ..storage.wal import Wal

    wal = Wal(path)
    last = wal.pop_last()
    if last is None:
        print("WAL is empty — nothing to pop", file=sys.stderr)
        return 1
    print(f"popped op {last}; next op num = {wal.next_op_num}", file=sys.stderr)
    return 0


def pop_raft_log(storage_dir: str) -> int:
    import msgpack

    log_path = os.path.join(storage_dir, "raft_log.msgpack")
    if not os.path.isfile(log_path):
        print(f"no raft log at {log_path}", file=sys.stderr)
        return 1
    with open(log_path, "rb") as f:
        entries = msgpack.unpackb(f.read(), raw=False)
    if not entries:
        print("raft log is empty — nothing to pop", file=sys.stderr)
        return 1
    popped = entries.pop()
    tmp = log_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(entries, use_bin_type=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, log_path)
    print(
        f"popped raft entry (index {popped.get('index') if isinstance(popped, dict) else '?'}); "
        f"{len(entries)} entries remain",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    path = argv[0]
    mode = argv[1] if len(argv) > 1 else "collection"
    if mode == "raft":
        return pop_raft_log(path)
    return pop_collection_wal(path)


if __name__ == "__main__":
    sys.exit(main())
