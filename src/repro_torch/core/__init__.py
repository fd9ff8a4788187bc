"""PackKV core in PyTorch: quantization -> V-median repacking -> tier
bit-packing -> seamless appending (the dense compute-tier format)."""
from .quantization import QuantConfig  # noqa: F401
from .tiered import TierBuffer, TierSpec, TieredCache  # noqa: F401
from .cache import LayerKVCache, PackKVConfig  # noqa: F401
from .policy import get_policy  # noqa: F401
