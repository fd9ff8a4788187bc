from .synthetic import (  # noqa: F401
    ShardedTokenStream,
    synthetic_kv,
    zipf_token_batch,
)
