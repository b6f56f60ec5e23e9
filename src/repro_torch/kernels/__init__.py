"""Hand-written Hopper kernels of the port, one package per TPU kernel,
and three layer kernels with no TPU counterpart (``rmsnorm``, ``rope``,
``silu_mul``, which route by ``build.no_grad_on_cuda``).

Each ``<name>/ops.py`` checks its inputs, launches the CUDA kernel from
``csrc/`` on CUDA tensors (built by ``build.py`` at first use) and runs the
plain PyTorch version in ``<name>/ref.py`` on CPU tensors.  Each wrapper
counts its launches in a plain integer attribute, ``<op>.launches``.
"""
