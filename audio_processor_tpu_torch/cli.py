"""CLI for the PyTorch/CUDA port, batch mode (port of cli.py).

    python -m audio_processor_tpu_torch.cli --config config.yaml --save-mode csv

Same flags as the reference CLI, plus ``--device`` (default ``cuda``;
the CLI refuses to start when CUDA is absent, and ``--device cpu`` must
be asked for). Wires DB + monitor + processor, runs retention cleanup
and the batch sweep(s); ``enable_profiling: true`` traces the first
sweep with torch.profiler (obs/profiler.py). ``--serve [--port P]
[--grpc-port G]`` runs the online server instead (serving.py, and
grpc_serving.py on G) on the same device, until SIGTERM or Ctrl-C
drains it.

Several processes: ``torchrun --nproc-per-node N -m
audio_processor_tpu_torch.cli ...`` (or the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``).
Each process joins the group (parallel/distributed.py; NCCL when each has
a card of its own, ``--dist-backend gloo`` to share one, gloo on the CPU),
runs on ``cuda:<LOCAL_RANK>`` and processes the calls it owns by call-id
hash; ``--serve`` runs a server in each process, as the reference does.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import sys
import threading
import time
from datetime import datetime
from pathlib import Path

import torch

from audio_processor_tpu_torch.config import load_config

logger = logging.getLogger(__name__)


def setup_logging(logs_folder: str) -> None:
    """Console + daily-rotating file logging
    (reference: run.py:32-49, pipeline.py:164-186)."""
    from logging.handlers import TimedRotatingFileHandler

    Path(logs_folder).mkdir(parents=True, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = Path(logs_folder) / f"tpu_processing_{ts}.log"
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    file_handler = TimedRotatingFileHandler(str(log_file), when="D",
                                            interval=1, backupCount=14)
    file_handler.setFormatter(fmt)
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(file_handler)
    root.addHandler(console)


def validate_config(cfg, serve: bool = False) -> None:
    """The reference's checks, then what the selected ASR model refuses
    (``models/seamless_s2t.check_pipeline_config``; ``serve``: under
    ``--serve``)."""
    cfg.validate()
    from audio_processor_tpu_torch.models.seamless_s2t import (
        check_pipeline_config,
    )

    check_pipeline_config(cfg, serve=serve)


def check_disk_space(min_free_gb: float) -> bool:
    """Disk-space gate (reference: run.py:137-143)."""
    free_gb = shutil.disk_usage("/").free / 1024 ** 3
    if free_gb < min_free_gb:
        logger.error("Insufficient disk space: %.1fGB free < %.1fGB "
                     "required", free_gb, min_free_gb)
        return False
    return True


def print_system_info(device: torch.device) -> None:
    logger.info("torch %s on %s%s", torch.__version__, device,
                f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
    try:
        import psutil

        vm = psutil.virtual_memory()
        logger.info("RAM: %.1fGB total, %.1f%% used",
                    vm.total / 1024 ** 3, vm.percent)
    except ImportError:
        pass


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Call-center audio analytics pipeline (PyTorch/CUDA)")
    p.add_argument("--config", default="config.yaml",
                   help="YAML configuration file")
    p.add_argument("--save-mode", choices=["database", "csv"],
                   default="database")
    p.add_argument("--dry-run", action="store_true",
                   help="scan and estimate only")
    p.add_argument("--performance-report", action="store_true")
    p.add_argument("--no-minio-sync", action="store_true")
    p.add_argument("--load-metadata", action="store_true")
    p.add_argument("--input", help="override input_folder")
    p.add_argument("--output", help="override output_folder")
    p.add_argument("--stats", action="store_true",
                   help="print database processing stats and exit")
    p.add_argument("--watch", type=float, metavar="SECONDS", default=0,
                   help="continuous mode: rescan the input folder every "
                        "N seconds instead of exiting (the reference "
                        "only supports cron re-invocation); idempotence "
                        "markers make each sweep incremental")
    p.add_argument("--serve", action="store_true",
                   help="online mode: HTTP inference server with "
                        "request micro-batching into the same fused "
                        "device program (serving.py)")
    p.add_argument("--port", type=int, default=8080,
                   help="--serve listen port")
    p.add_argument("--grpc-port", type=int, default=0,
                   help="with --serve: also expose the gRPC service "
                        "on this port (0 = HTTP only)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the ASR program (default cuda; "
                        "cpu only when asked for; under several processes "
                        "cuda means cuda:<LOCAL_RANK>)")
    p.add_argument("--dist-backend", default=None,
                   help="process-group backend under several processes "
                        "(default NCCL, which needs a card per process; "
                        "gloo on the CPU or to share a card)")
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is False "
            "(pass --device cpu to run on the CPU)")
    return device


def run_server(args, cfg, db_manager, monitor, device: torch.device
               ) -> int:
    """``--serve``: the HTTP server (and the gRPC one with
    ``--grpc-port``) over one engine on ``device``, until SIGTERM or
    Ctrl-C; then drain, stop the monitor and close the database."""
    from audio_processor_tpu_torch.pipeline.sentiment import (
        SentimentAnalyzer,
    )
    from audio_processor_tpu_torch.serving import serve

    analyzer = SentimentAnalyzer(cfg, db_manager=db_manager, device=device)
    server = serve(cfg, port=args.port, sentiment_analyzer=analyzer,
                   device=device)
    logger.info("Online inference server on port %d "
                "(POST /v1/transcribe, GET /healthz, /v1/stats)",
                server.server_address[1])
    grpc_server = None
    try:
        if args.grpc_port:
            from audio_processor_tpu_torch.grpc_serving import (
                GrpcInferenceServer,
            )

            grpc_server = GrpcInferenceServer(server.service,
                                              args.grpc_port)
            grpc_server.start()
        # Graceful Docker/K8s shutdown: SIGTERM drains like Ctrl-C.
        # server.shutdown() must run on another thread — it joins the
        # serve_forever loop this thread is inside. Only the main
        # thread may install a signal handler.
        if threading.current_thread() is threading.main_thread():
            def _sigterm(_signum, _frame):
                logger.info("SIGTERM received; shutting down server")
                threading.Thread(target=server.shutdown,
                                 daemon=True).start()

            signal.signal(signal.SIGTERM, _sigterm)
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Interrupted; shutting down server")
    finally:
        if grpc_server is not None:
            grpc_server.stop()
        server.service.close()
        server.server_close()
        if monitor is not None:
            monitor.stop_monitoring()
        if db_manager is not None:
            db_manager.close()
    return 0


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)

    overrides = {"save_csv_results": args.save_mode == "csv"}
    if args.input:
        overrides["input_folder"] = args.input
    if args.output:
        overrides["output_folder"] = args.output
    cfg = load_config(args.config, overrides)
    setup_logging(cfg.logs_folder)
    from audio_processor_tpu_torch.parallel import distributed as pdist
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    pdist.initialize_distributed(
        backend=args.dist_backend or ("gloo" if device.type == "cpu"
                                      else None))
    if pdist.process_count() > 1 and args.device == "cuda":
        device = pdist.local_device("cuda")
    try:
        validate_config(cfg, serve=args.serve)
    except ValueError as e:
        logger.error("Invalid configuration: %s", e)
        return 2
    if not check_disk_space(float(os.environ.get("MIN_FREE_DISK_GB", "5"))):
        return 3
    print_system_info(device)

    if cfg.minio.enabled and not args.no_minio_sync:
        from audio_processor_tpu_torch.host.minio_sync import MinIOSyncManager

        MinIOSyncManager(cfg).sync_to_local(cfg.input_folder)

    if args.dry_run:
        from audio_processor_tpu_torch.io.scanner import AudioFileScanner

        files = AudioFileScanner(cfg).scan_files_parallel(
            Path(cfg.input_folder))
        logger.info("Dry run: %d valid files found", len(files))
        return 0

    db_manager = None
    if args.save_mode == "database" or args.load_metadata or args.stats:
        from audio_processor_tpu_torch.host.db import DatabaseManager

        try:
            db_manager = DatabaseManager(cfg)
        except Exception as e:
            logger.error("Database unavailable: %s", e)
            if args.save_mode == "database":
                return 4

    if args.stats:
        if db_manager is None:
            logger.error("--stats requires a database")
            return 4
        import json

        print(json.dumps(db_manager.get_processing_stats(), indent=2))
        db_manager.close()
        return 0

    if args.load_metadata and db_manager is not None:
        from audio_processor_tpu_torch.host.metadata import load_metadata

        load_metadata(db_manager, cfg)

    monitor = None
    if cfg.enable_performance_monitoring:
        from audio_processor_tpu_torch.obs.monitor import PerformanceMonitor

        monitor = PerformanceMonitor(cfg, device=device)
        monitor.start_monitoring()

    if args.serve:
        return run_server(args, cfg, db_manager, monitor, device)

    from audio_processor_tpu_torch.host.topics import TopicClassifier

    processor = DataProcessor(cfg, db_manager=db_manager,
                              topic_classifier=TopicClassifier(
                                  cfg, device=device),
                              monitor=monitor, device=device)
    if monitor is not None:
        monitor.add_callback("queues", processor.get_queue_metrics)
    processor.cleanup_old_artifacts()

    rc = 0
    try:
        from audio_processor_tpu_torch.obs.profiler import maybe_trace

        with maybe_trace(cfg):
            processor.run()
        while args.watch > 0:
            logger.info("Watch mode: sleeping %.0fs before next sweep",
                        args.watch)
            time.sleep(args.watch)
            if cfg.minio.enabled and not args.no_minio_sync:
                from audio_processor_tpu_torch.host.minio_sync import (
                    MinIOSyncManager,
                )

                MinIOSyncManager(cfg).sync_to_local(cfg.input_folder)
            processor.run()
    except KeyboardInterrupt:
        logger.info("Interrupted; shutting down")
    except Exception as e:
        logger.exception("Processing failed: %s", e)
        rc = 1
    finally:
        processor.close()
        if monitor is not None:
            monitor.stop_monitoring()
            if args.performance_report:
                monitor.save_performance_report(cfg.output_folder)
        if db_manager is not None:
            db_manager.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
