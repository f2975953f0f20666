"""CLI for the PyTorch/CUDA port, batch mode (port of cli.py).

    python -m audio_processor_tpu_torch.cli --config config.yaml --save-mode csv

Same flags as the reference CLI, plus ``--device`` (default ``cuda``;
the CLI refuses to start when CUDA is absent, and ``--device cpu`` must
be asked for). Wires DB + monitor + processor, runs retention cleanup
and the batch sweep(s). ``--serve`` (HTTP/gRPC serving) is not ported
yet.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

import torch

from audio_processor_tpu.cli import (
    build_arg_parser as _reference_arg_parser, check_disk_space,
    setup_logging,
)
from audio_processor_tpu.config import load_config

logger = logging.getLogger(__name__)


def build_arg_parser():
    p = _reference_arg_parser()
    p.description = "Call-center audio analytics pipeline (PyTorch/CUDA)"
    p.add_argument("--device", default="cuda",
                   help="torch device for the ASR program (default cuda; "
                        "cpu only when asked for)")
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is False "
            "(pass --device cpu to run on the CPU)")
    return device


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.serve:
        raise NotImplementedError(
            "--serve is not ported yet (ROADMAP.md, Queue 1: serving)")
    device = resolve_device(args.device)

    overrides = {"save_csv_results": args.save_mode == "csv"}
    if args.input:
        overrides["input_folder"] = args.input
    if args.output:
        overrides["output_folder"] = args.output
    cfg = load_config(args.config, overrides)
    setup_logging(cfg.logs_folder)
    try:
        cfg.validate()
    except ValueError as e:
        logger.error("Invalid configuration: %s", e)
        return 2
    if not check_disk_space(float(os.environ.get("MIN_FREE_DISK_GB", "5"))):
        return 3
    logger.info("torch %s on %s%s", torch.__version__, device,
                f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")

    if cfg.minio.enabled and not args.no_minio_sync:
        from audio_processor_tpu.host.minio_sync import MinIOSyncManager

        MinIOSyncManager(cfg).sync_to_local(cfg.input_folder)

    if args.dry_run:
        from audio_processor_tpu.io.scanner import AudioFileScanner

        files = AudioFileScanner(cfg).scan_files_parallel(
            Path(cfg.input_folder))
        logger.info("Dry run: %d valid files found", len(files))
        return 0

    db_manager = None
    if args.save_mode == "database" or args.load_metadata or args.stats:
        from audio_processor_tpu.host.db import DatabaseManager

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
        from audio_processor_tpu.host.metadata import load_metadata

        load_metadata(db_manager, cfg)

    monitor = None
    if cfg.enable_performance_monitoring:
        from audio_processor_tpu.obs.monitor import PerformanceMonitor

        monitor = PerformanceMonitor(cfg)
        monitor.start_monitoring()

    from audio_processor_tpu.host.topics import TopicClassifier
    from audio_processor_tpu_torch.pipeline.engine import DataProcessor

    processor = DataProcessor(cfg, db_manager=db_manager,
                              topic_classifier=TopicClassifier(cfg),
                              monitor=monitor, device=device)
    if monitor is not None:
        monitor.add_callback("queues", processor.get_queue_metrics)
    processor.cleanup_old_artifacts()

    rc = 0
    try:
        processor.run()
        while args.watch > 0:
            logger.info("Watch mode: sleeping %.0fs before next sweep",
                        args.watch)
            time.sleep(args.watch)
            if cfg.minio.enabled and not args.no_minio_sync:
                from audio_processor_tpu.host.minio_sync import (
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
