"""Process entry point: `python -m qdrant_tpu_torch --storage-dir ... --http-port ...`.

Loads settings, opens the storage root (TableOfContent) and serves the REST
API, and gRPC on `service.grpc_port` where the `grpc` package is installed
(without it the server logs that gRPC did not start and serves REST), on the
CUDA device. Without a card it refuses to start unless the CPU was asked for
(`--force-cpu` or QDRANT_TPU_FORCE_CPU=1); then the kernels' plain versions
run. Ctrl-C flushes all collections before exit.

Cluster mode (`--uri`; `cluster.enabled` without it is refused): the peer
takes the id `--peer-id` or crc32 of `--uri`, joins an existing peer named
by `--bootstrap` (POST /cluster/bootstrap, which commits it as a member and
returns the membership), and runs a ClusterNode (Raft metadata consensus,
replicated shards, remote search, shard transfer) whose log lives under
<storage>/raft. Peer-to-peer traffic is HTTP on the REST port.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="qdrant_tpu_torch", description="vector search engine on PyTorch / CUDA"
    )
    parser.add_argument("--config-path", help="path to a config yaml overriding the cascade")
    parser.add_argument("--storage-dir", help="override storage.storage_path")
    parser.add_argument("--http-port", type=int, help="override service.http_port")
    parser.add_argument("--host", help="override service.host")
    parser.add_argument("--uri", help="this peer's public URL (enables cluster mode)")
    parser.add_argument("--bootstrap", help="URL of an existing peer to join")
    parser.add_argument("--peer-id", type=int, help="stable peer id (default: derived from uri)")
    parser.add_argument(
        "--force-cpu", action="store_true", help="run on the CPU even when a GPU is present"
    )
    args = parser.parse_args(argv)
    if args.bootstrap and not args.uri:
        parser.error("--bootstrap needs --uri: the URL the other peers reach this one at")

    from .device import default_device, force_cpu

    if args.force_cpu:
        force_cpu()
    try:  # no card and no request for the CPU: refuse to start
        device = default_device()
    except RuntimeError as exc:
        parser.error(str(exc))

    if args.config_path:
        os.environ["QDRANT_CONFIG_PATH"] = args.config_path

    from .settings import Settings

    settings = Settings.load()
    if args.storage_dir:
        settings["storage"]["storage_path"] = args.storage_dir
    if args.http_port:
        settings["service"]["http_port"] = args.http_port
    if args.host:
        settings["service"]["host"] = args.host
    if settings.get_path("cluster.enabled", False) and not args.uri:
        parser.error("cluster.enabled needs --uri: the URL the other peers reach this one at")

    logging.basicConfig(
        level=getattr(logging, str(settings.get("log_level", "INFO")).upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("qdrant_tpu_torch")

    on_disk_cfg = (settings.get("logger") or {}).get("on_disk") or {}
    if on_disk_cfg.get("enabled"):
        from .utils.telemetry import configure_on_disk_logging

        try:
            configure_on_disk_logging(on_disk_cfg)
            log.info("on-disk log sink: %s", on_disk_cfg.get("log_file"))
        except Exception as exc:
            log.error("failed to enable on-disk log sink: %s", exc)

    from .utils.flags import init_feature_flags

    init_feature_flags(settings.get("feature_flags"))

    lmm = settings.get_path("storage.low_memory_mode", "disabled")
    if lmm and lmm != "disabled":
        from .storage.segment import set_low_memory_mode

        set_low_memory_mode(lmm)
        log.warning("low_memory_mode=%s: segments load on-disk/unpopulated", lmm)

    if settings.get_path("service.service_debug", False):
        from .utils.debug import WATCHDOG

        WATCHDOG.configure({"enabled": True})
        log.info("service debug: stall watchdog enabled")

    from .api.rest import RestServer
    from .api.toc import TableOfContent

    storage_path = settings.get_path("storage.storage_path", "./storage")
    toc = TableOfContent(
        storage_path,
        flush_interval_sec=settings.get_path("storage.optimizers.flush_interval_sec", 5),
        snapshots_config={
            "snapshots_storage": settings.get_path("storage.snapshots_storage", "local"),
            "s3_config": settings.get_path("storage.s3_config", None),
        },
        quota_config=settings.get_path("storage.quota", None),
    )
    inf_cfg = settings.get("inference") or {}
    if inf_cfg.get("address"):
        from .utils import inference as _inference

        _inference.configure(
            inf_cfg["address"],
            token=inf_cfg.get("token"),
            timeout=float(inf_cfg.get("timeout") or 10.0),
        )
        log.info("inference service: %s", inf_cfg["address"])

    host = settings.get_path("service.host", "127.0.0.1")
    port = int(settings.get_path("service.http_port", 6333))
    api_key = settings.get_path("service.api_key")

    cluster_node = None
    if args.uri:
        cluster_node = _start_cluster_node(args, settings, toc, storage_path, api_key)
        log.info(
            "cluster mode: peer %d at %s (%d peers)",
            cluster_node.peer_id, args.uri, len(cluster_node.all_peer_ids()),
        )
    server = RestServer(
        toc,
        host=host,
        port=port,
        api_key=api_key,
        read_only_api_key=settings.get_path("service.read_only_api_key"),
        static_content_dir=settings.get_path("service.static_content_dir", "./static"),
        enable_static_content=bool(settings.get_path("service.enable_static_content", True)),
    )

    reporter = None
    if not settings.get("telemetry_disabled", False):
        from .utils.telemetry import TelemetryReporter

        reporter = TelemetryReporter(
            toc, url=settings.get_path("service.telemetry_url", None)
        )
        reporter.start()
        log.info("anonymized telemetry reporting enabled (hourly)")
    log.info(
        "qdrant-tpu-torch listening on http://%s:%d (storage: %s, device: %s)",
        host, server.port, storage_path, device,
    )

    grpc_server = None
    try:  # the grpc package is optional: REST and the device never need it
        from .api.grpc_server import make_server

        grpc_server, bound = make_server(
            toc,
            host=host,
            port=int(settings.get_path("service.grpc_port", 6334)),
            api_key=api_key,
            read_only_api_key=settings.get_path("service.read_only_api_key"),
        )
        grpc_server.start()
        log.info("qdrant-tpu-torch gRPC listening on %s:%d", host, bound)
    except Exception as e:  # grpc runtime optional
        log.warning("gRPC server not started: %s", e)

    def shutdown(signum, frame):
        log.info("shutting down; flushing collections")
        if reporter is not None:
            reporter.stop()
        if cluster_node is not None:
            cluster_node.stop()
        if grpc_server is not None:
            grpc_server.stop(2)
        # serve_forever runs on this thread, which the handler interrupts:
        # httpd.shutdown() waits for that loop to exit, so call it from
        # another thread; the collections flush in the finally below
        threading.Thread(target=server.httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    try:
        server.serve_forever()
    finally:
        toc.close()
    return 0


def _start_cluster_node(args, settings, toc, storage_path, api_key):
    """This peer's ClusterNode: its id, the membership (this peer alone, or
    what the `--bootstrap` peer returns after committing it as a member),
    the Raft tick from `cluster.consensus.tick_period_ms`, the log under
    <storage>/raft."""
    import binascii
    import json
    import urllib.request

    from .cluster.node import ClusterNode

    peer_id = args.peer_id or (binascii.crc32(args.uri.encode()) & 0x7FFFFFFF)
    peer_urls = {peer_id: args.uri}
    if args.bootstrap:
        req = urllib.request.Request(
            args.bootstrap.rstrip("/") + "/cluster/bootstrap",
            method="POST",
            data=json.dumps({"peer_id": peer_id, "url": args.uri}).encode(),
            headers={"Content-Type": "application/json",
                     **({"api-key": api_key} if api_key else {})},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            peers = json.loads(resp.read())["result"]["peers"]
        peer_urls.update({int(k): v for k, v in peers.items()})
    node = ClusterNode(
        peer_id,
        toc,
        peer_urls,
        tick_period=float(settings.get_path("cluster.consensus.tick_period_ms", 100)) / 1000.0,
        raft_storage=os.path.join(storage_path, "raft"),
        api_key=api_key,
    )
    node.start()
    return node


if __name__ == "__main__":
    sys.exit(main())
