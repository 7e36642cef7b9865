"""PyTorch port of the NAT system for NVIDIA Hopper (H100).

Beside the JAX reference in ``src/repro/``, module for module: the serving
slice (``models/``, ``kernels/paged_attn``, ``rl/engine.py``,
``serve/server.py``) serves dense GQA models such as ``nat-qwen3-8b`` from
a paged KV pool, with paged decode attention in a hand-written CUDA kernel.
The package imports ``torch`` and never ``jax`` or ``repro``."""
