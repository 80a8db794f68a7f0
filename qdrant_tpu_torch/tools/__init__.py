"""Operational inspection tools (reference: src/wal_inspector.rs,
src/segment_inspector.rs — cargo-run debug binaries; here python -m
subcommands)."""
