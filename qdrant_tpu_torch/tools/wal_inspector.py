"""Inspect a WAL directory: `python -m qdrant_tpu_torch.tools.wal_inspector
<wal_dir> [collection|raft]` (counterpart of
qdrant_tpu/tools/wal_inspector.py; reference: src/wal_inspector.rs — prints
every operation with its number; raft mode prints consensus entries).
Reading the WAL does no tensor work, so it needs no device."""

from __future__ import annotations

import json
import sys


def print_collection_wal(path: str, from_op: int = 0, limit: int = 0) -> int:
    """JSON-lines on stdout ({"op_num", "operation"}), summary on stderr —
    machine-parseable, like the reference's wal_inspector."""
    from ..storage.wal import Wal

    wal = Wal(path)
    first = None
    count = 0
    last = 0
    for op_num, op in wal.read_from(from_op):
        if limit and count >= limit:
            break
        if first is None:
            first = op_num
        last = op_num
        count += 1
        print(json.dumps({"op_num": op_num, "operation": op}, default=str))
    print(
        f"{count} records (first: {first}, last: {last}, "
        f"next op num: {wal.next_op_num})",
        file=sys.stderr,
    )
    return 0


def print_raft_wal(path: str) -> int:
    import os

    import msgpack

    state_file = os.path.join(path, "raft_state.json")
    log_file = os.path.join(path, "raft_log.msgpack")
    if os.path.exists(state_file):
        with open(state_file) as f:
            print(f"state: {f.read().strip()}")
    if os.path.exists(log_file):
        with open(log_file, "rb") as f:
            entries = msgpack.unpackb(f.read(), raw=False)
        for e in entries:
            print(f"entry #{e['index']} (term {e['term']}): "
                  f"{json.dumps(e['operation'], default=str)}")
        print("==========================")
        print(f"entries: {len(entries)}")
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="wal_inspector")
    parser.add_argument("path")
    parser.add_argument("kind", nargs="?", default="collection",
                        choices=["collection", "raft"])
    parser.add_argument("--from", dest="from_op", type=int, default=0)
    parser.add_argument("--limit", type=int, default=0)
    args = parser.parse_args(argv)
    if args.kind == "collection":
        return print_collection_wal(args.path, args.from_op, args.limit)
    return print_raft_wal(args.path)


if __name__ == "__main__":
    sys.exit(main())
