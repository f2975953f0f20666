"""audio_processor_tpu_torch — the PyTorch/CUDA port of audio_processor_tpu.

A second package beside the JAX reference. It mirrors the reference's
module paths (``dsp/``, ``models/``, ``pipeline/``, ``cli.py``) and
imports its JAX-free host modules (config, io, chunking, batching,
markers, CSV/DB writers, tokenizer) instead of copying them. Plain
tensor code is PyTorch; the reference's Pallas kernel on the main path
is a hand-written CUDA kernel for Hopper (``csrc/``, built by
``_build.py``). This package imports ``torch`` and never ``jax``.
"""
