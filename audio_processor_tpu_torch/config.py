"""Typed configuration for the TPU audio pipeline.

Accepts the same YAML surface as the reference's ``config.yaml``
(reference: config.yaml:1-132, run.py:52-65) but validates it into a
frozen dataclass instead of threading a raw dict through every
constructor. Unknown keys are preserved in ``extras`` so downstream
components can still read bespoke knobs.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class MinioConfig:
    endpoint: str = ""
    enabled: bool = False
    bucket_name: str = ""
    folder_prefix: str = "input"
    secure: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    # Parallel processing (reference: config.yaml:3-7)
    max_workers: int = 16
    io_workers: int = 32
    gpu_workers: int = 1
    gpu_index: int = 0

    # Device scale-out. The reference uses process-per-GPU
    # (config.yaml:10-11); here a single process shards over a
    # jax.sharding.Mesh with `data_axis_size` devices.
    use_multi_gpu: bool = True            # kept for YAML compat
    max_gpus: int = 4                     # kept for YAML compat
    mesh_shape: Optional[Dict[str, int]] = None   # e.g. {"data": 8}

    # Memory management (config.yaml:13-17)
    max_memory_gb: float = 500.0
    chunk_cache_size: int = 1000
    enable_memory_mapping: bool = True
    enable_compression: bool = True

    # Batching (config.yaml:19-25)
    file_batch_size: int = 32
    chunk_batch_size: int = 16
    max_chunk_duration: float = 25.0
    chunk_duration_sec: float = 25.0
    overlap_sec: float = 1.0
    max_batch_size_mb: float = 23.0

    # Precision (config.yaml:27-30). bf16 is the TPU-native default.
    gpu_memory_fraction: float = 0.9
    enable_mixed_precision: bool = True
    enable_gradient_checkpointing: bool = False
    # "int8": W8A8 encoder matmuls (2x MXU rate on v5e); "none" keeps
    # the bit-match-parity bf16/fp32 path (default).
    quantization: str = "none"

    # I/O (config.yaml:33-35)
    prefetch_factor: int = 3
    temp_dir: str = "/tmp/audio_processing"

    # Paths (config.yaml:38-42)
    input_folder: str = "./input"
    output_folder: str = "./output"
    failed_folder: str = "./failed"
    logs_folder: str = "./logs"

    # Model paths (config.yaml:45-53)
    transcription_model: str = ""
    client_text_model_path: str = ""
    client_acoustic_model_path: str = ""
    client_acoustic_scaler_path: str = ""
    agent_text_model_path: str = ""
    agent_acoustic_model_path: str = ""
    agent_acoustic_scaler_path: str = ""

    # VAD (config.yaml:56-62)
    vad_model_id: str = ""
    vad_device: str = "tpu"
    vad_max_segment_sec: float = 25.0
    vad_window_overlap_sec: float = 0.5
    vad_gap_threshold: float = 0.8
    vad_padding: float = 0.5
    # PyanNet inference windowing (TPU-native): fixed-size sliding
    # windows batched into one static-shape program with overlap
    # averaging — the same regime as pyannote's Inference sliding
    # window (the hub VAD pipeline's duration is 5 s), and the only
    # XLA-friendly way to run arbitrary-length calls without
    # per-length recompiles.
    vad_infer_window_sec: float = 5.0
    vad_infer_step_sec: float = 2.5
    vad_infer_batch_rows: int = 16

    # Audio (config.yaml:64-66)
    target_sample_rate: int = 16000
    max_audio_length: float = 1800.0

    # Output (config.yaml:68-73)
    output_format: str = "csv"
    enable_progress_tracking: bool = True
    save_intermediate_results: bool = True
    save_sentiment_analysis: bool = True
    save_csv_results: bool = True

    # Idempotence / retention (config.yaml:75-77)
    retention_days: int = 30
    delete_processed_files: bool = False

    # Tuning (config.yaml:79-81)
    max_auto_batch_size: int = 64
    enable_length_bucketing: bool = True
    # Consult the advisory tuners (PerformanceMonitor.optimize_batch_
    # size / optimize_worker_count) at sweep end and surface their
    # recommendation in the log + run summary. Advisory ONLY: device
    # batch shapes are static length buckets and the file batch size
    # is chosen for padding geometry (8 PCM16 calls pack the 25 s
    # bucket into zero-pad sub-batches), so auto-applying a
    # wall-time-targeted halving/doubling would regress throughput.
    # The reference's tuner is never called at all
    # (performance_monitor.py:272-304).
    enable_auto_batch_size: bool = False

    # Monitoring (config.yaml:83-87)
    enable_performance_monitoring: bool = True
    log_memory_usage: bool = True
    log_processing_times: bool = True
    performance_metrics_interval: int = 100

    # Error handling (config.yaml:89-92)
    max_retries: int = 3
    timeout_seconds: int = 300
    continue_on_error: bool = True
    # Abort a sweep after this many errors (reference hardcodes 10,
    # pipeline.py:386).
    max_errors: int = 10

    # Device pipelining (TPU-native; no reference equivalent): overlap
    # batch N+1's device dispatch with batch N's result fetch/
    # analysis, bounded to max_inflight_batches outstanding batches.
    async_device_fetch: bool = True
    max_inflight_batches: int = 3

    # Resource limits (config.yaml:94-97)
    max_concurrent_files: int = 64
    max_concurrent_chunks: int = 1000
    memory_threshold_percent: int = 80

    # Database (config.yaml:101-107). `sqlite` backend added for
    # dependency-free deployments; `postgresql` preserved.
    database_type: str = "postgresql"
    db_host: str = "localhost"
    db_port: int = 55432
    db_name: str = "audio_processing"
    db_user: str = "postgres"
    db_password: str = ""
    db_path: str = ""  # sqlite file path ("" -> <output_folder>/audio.db)

    # Business / Bedrock (config.yaml:109-118)
    partenaire: str = "INWI"
    login_conseiller: str = "system"
    bedrock_region: str = "us-west-2"
    summary_model_id: str = "anthropic.claude-3-5-sonnet-20240620-v1:0"
    class_model_id: str = "anthropic.claude-3-5-sonnet-20240620-v1:0"
    max_tokens_summary: int = 300
    max_tokens_class: int = 3
    temperature: float = 0.0
    # Topics on the card (host/topics.py) are read from `extras`, so the
    # fields stay the JAX package's: `topic_backend` "bedrock" (above, the
    # default) or "local", a decoder-only MoE LM (models/moe_lm.py) whose
    # widths are `topic_model`'s config.json keys (empty:
    # Moonlight-16B-A3B's), with the seed of its stand-in piece table,
    # `topic_vocab_seed` (0), until its files are in the repository.

    # Glossaries / dictionaries (config.yaml:120-125)
    business_type: str = "B2C"
    topics_glossary_b2c: str = ""
    topics_glossary_b2b: str = ""
    darija_french_dict: str = ""
    darija_numbers_dict: str = ""

    minio: MinioConfig = field(default_factory=MinioConfig)

    # Static-shape bucketing for XLA: audio chunk lengths are padded up
    # to one of these durations (seconds) so each bucket compiles once.
    length_buckets_sec: tuple = (5.0, 10.0, 15.0, 20.0, 25.0)

    # Anything in the YAML we don't model explicitly.
    extras: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def chunk_samples(self) -> int:
        return int(self.chunk_duration_sec * self.target_sample_rate)

    @property
    def overlap_samples(self) -> int:
        return int(self.overlap_sec * self.target_sample_rate)

    @property
    def step_samples(self) -> int:
        return self.chunk_samples - self.overlap_samples

    def get(self, key: str, default: Any = None) -> Any:
        """Dict-style access kept for facade compatibility with the
        reference, where every component does ``config.get(...)``."""
        if hasattr(self, key):
            return getattr(self, key)
        return self.extras.get(key, default)

    def __getitem__(self, key: str) -> Any:
        sentinel = object()
        val = self.get(key, sentinel)
        if val is sentinel:
            raise KeyError(key)
        return val

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key) or key in self.extras

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extras = d.pop("extras", {})
        d.update(extras)
        return d

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "PipelineConfig":
        raw = dict(raw or {})
        minio_raw = raw.pop("minio", {}) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        extras: Dict[str, Any] = {}
        for k, v in raw.items():
            if k in known and k not in ("minio", "extras"):
                kwargs[k] = v
            else:
                extras[k] = v
        minio_known = {f.name for f in dataclasses.fields(MinioConfig)}
        minio = MinioConfig(**{k: v for k, v in minio_raw.items() if k in minio_known})
        if "length_buckets_sec" in kwargs:
            kwargs["length_buckets_sec"] = tuple(kwargs["length_buckets_sec"])
        return cls(minio=minio, extras=extras, **kwargs)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "PipelineConfig":
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    def validate(self) -> None:
        """Required-path validation (reference: run.py:67-85)."""
        problems = []
        if not self.input_folder:
            problems.append("input_folder is required")
        if not self.output_folder:
            problems.append("output_folder is required")
        if not self.logs_folder:
            problems.append("logs_folder is required")
        if self.overlap_sec >= self.chunk_duration_sec:
            problems.append("overlap_sec must be < chunk_duration_sec")
        if self.target_sample_rate <= 0:
            problems.append("target_sample_rate must be positive")
        if self.chunk_batch_size <= 0:
            problems.append("chunk_batch_size must be positive")
        if problems:
            raise ValueError("Invalid configuration: " + "; ".join(problems))


def load_config(path: Optional[str | Path] = None,
                overrides: Optional[Dict[str, Any]] = None) -> PipelineConfig:
    """Load config from YAML (or defaults) and apply CLI overrides."""
    if path is not None and Path(path).exists():
        cfg = PipelineConfig.from_yaml(path)
    else:
        cfg = PipelineConfig()
    if overrides:
        known = {f.name for f in dataclasses.fields(PipelineConfig)}
        direct = {k: v for k, v in overrides.items() if k in known}
        extra = {k: v for k, v in overrides.items() if k not in known}
        if extra:
            merged = dict(cfg.extras)
            merged.update(extra)
            direct["extras"] = merged
        cfg = cfg.replace(**direct)
    return cfg


def env_secret(name: str, default: str = "") -> str:
    """Secrets come from the environment (reference: env.example:1-24)."""
    return os.environ.get(name, default)
