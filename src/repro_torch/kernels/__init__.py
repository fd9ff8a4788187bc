"""Hand-written CUDA kernels for the compressed-cache decode path, each
beside its plain PyTorch version. ``ops.py`` dispatches between the
``"ref"`` (oracle) and ``"fused"`` (kernel) backends."""
from .ops import (  # noqa: F401
    dense_decode_attention,
    merge_partials,
    packed_decode_attention,
    paged_decode_attention,
)
