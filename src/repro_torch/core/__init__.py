"""PackKV core in PyTorch: the paper's pipeline (quantization ->
encode-aware repacking -> bit-packing -> seamless appending ->
computation-aware decompression) in two formats:

  * storage tier (``bitpack.py``, ``block_format.py``): the paper's exact
    format with per-pack adaptive widths; CR accounting and offload;
  * compute tier (``tiered.py``): the static-shape format the fused CUDA
    kernels of ``repro_torch.kernels`` read.
"""
from .quantization import QuantConfig, dequantize, quantize  # noqa: F401
from .bitpack import (  # noqa: F401
    DEFAULT_SIZE_MODEL,
    SizeModel,
    compression_ratio,
    pack_block,
    packed_total_bits,
    unpack_block,
)
from .repacking import greedy_repack, median_repack, repack  # noqa: F401
from .block_format import CompressedKVStream  # noqa: F401
from .tiered import (  # noqa: F401
    TierBuffer,
    TierSpec,
    TieredCache,
    alloc_tiered,
    append_block,
    assign_channel_tiers,
    dequantize_tiered,
    pack_tiered,
    required_channel_widths,
    tiered_bits_per_value,
    unpack_tiered,
)
from .kivi import KIVIConfig, kivi_cr, kivi_cr_from_rel_scale  # noqa: F401
from .cache import LayerKVCache, PackKVConfig  # noqa: F401
from .policy import get_policy  # noqa: F401
