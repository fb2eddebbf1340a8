"""repro_torch — the PyTorch/CUDA port of ``repro`` (dynamic graph
representations), for NVIDIA Hopper GPUs.

Host planning stays numpy, device payloads are torch tensors, and each
Pallas TPU kernel of ``repro`` on the ported path is a hand-written CUDA
kernel (``csrc/``, built at first use).  Entry points take ``device=``
and default to ``"cuda"``; the package never imports ``jax`` or ``repro``.
"""
