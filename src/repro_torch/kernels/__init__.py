"""Hand-written CUDA kernels over the compressed cache, each beside its
plain PyTorch version. ``ops.py`` dispatches between the ``"ref"``
(oracle) and ``"fused"`` (kernel) backends."""
from .ops import (  # noqa: F401
    dense_decode_attention,
    merge_partials,
    packed_decode_attention,
    packed_qk_scores,
    packed_qk_scores_paged,
    packed_weighted_v,
    packed_weighted_v_paged,
    paged_decode_attention,
)
