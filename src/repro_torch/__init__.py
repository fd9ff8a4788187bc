"""PackKV in PyTorch: the serving path of ``repro`` ported to CUDA GPUs.

Module names mirror the JAX package (``repro``) one for one, so each
module's counterpart is found by name. This package imports ``torch``
only; it never imports JAX or ``repro``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""
