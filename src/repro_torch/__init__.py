"""KVDirect disaggregated LLM inference in PyTorch and CUDA — the port of
the JAX package ``repro`` to an NVIDIA H100.

Same layout as ``repro`` so each module's counterpart is easy to find;
imports ``torch`` (and numpy), never ``jax`` and nothing of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
