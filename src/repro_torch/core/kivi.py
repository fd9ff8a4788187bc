"""KIVI baseline (Liu et al. 2024), the paper's accuracy / CR comparison
point; the torch port of ``repro/core/kivi.py``.

KIVI quantizes K **channel-wise** (per channel, grouped along the context
dim) and V **token-wise**, keeping a small residual window of recent
tokens in full precision. Bit widths are integers (2/3/4); the
compression ratio includes fp16 (scale, zero) metadata per group:

  CR(b, g) = 16 / (b + 32/g)

e.g. 2-bit / 64-group 6.4x, 3-bit / 64 4.57x, 4-bit / 128 ~3.56x, the
numbers the paper quotes in section III-B2.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .quantization import (
    QuantConfig,
    dequantize_channelwise,
    dequantize_tokenwise,
    quantize_channelwise,
    quantize_tokenwise,
)


@dataclasses.dataclass(frozen=True)
class KIVIConfig:
    k_bits: int = 2
    v_bits: int = 2
    group_size: int = 64  # K channel-group length along context
    residual: int = 128  # recent tokens kept in fp16


def kivi_cr(bits: int, group_size: int, raw_bits: int = 16) -> float:
    return raw_bits / (bits + 32.0 / group_size)


def kivi_cr_from_rel_scale(rel_scale: float, group_size: int = 64) -> float:
    """CR of the smallest integer bit width whose error <= rel_scale / 2.

    b-bit quantization has rel error bound 1 / (2 (2^b - 1)); the smallest
    b with 1 / (2^b - 1) <= rel_scale is b = ceil(log2(1/rel + 1)). The
    levels round UP here (``QuantConfig.levels`` rounds to nearest).
    """
    levels = int(math.ceil(1.0 / rel_scale)) + 1
    bits = int(math.ceil(math.log2(levels)))
    bits = max(2, min(bits, 8))  # KIVI supports integer widths >= 2
    return kivi_cr(bits, group_size)


def compress_k(k: torch.Tensor, cfg: KIVIConfig):
    qc = QuantConfig(granularity="channel", group_size=cfg.group_size, bits=cfg.k_bits)
    return quantize_channelwise(k, qc)


def decompress_k(q, scale, zero, cfg: KIVIConfig, dtype=torch.float32):
    return dequantize_channelwise(q, scale, zero, cfg.group_size, dtype)


def compress_v(v: torch.Tensor, cfg: KIVIConfig):
    qc = QuantConfig(granularity="token", bits=cfg.v_bits)
    return quantize_tokenwise(v, qc)


def decompress_v(q, scale, zero, cfg: KIVIConfig, dtype=torch.float32):
    return dequantize_tokenwise(q, scale, zero, dtype)
