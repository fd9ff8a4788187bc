"""SmolLM-135M: a small llama-architecture model, GQA at G = 3 with head
dim 64 [hf:HuggingFaceTB/SmolLM-135M]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576, n_heads=9,
    n_kv_heads=3, d_ff=1536, vocab=49152,
)

SMOKE = ArchConfig(
    name="smollm-135m-smoke", family="dense", n_layers=2, d_model=96, n_heads=3,
    n_kv_heads=1, d_ff=192, vocab=512, head_dim=32,
)
