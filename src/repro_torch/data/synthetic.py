"""Synthetic data pipeline.

Two generators:

* ``zipf_token_batch`` / ``ShardedTokenStream`` — deterministic Zipf-
  distributed LM token stream with per-host sharding (the training data
  substrate; real deployments swap in a tokenized corpus behind the same
  iterator protocol).

* ``synthetic_kv`` — KV-cache-like tensors with the structure the paper
  measures on real models (Figs 3–4): strong per-channel offsets, smooth
  variation along the context dimension (channel correlation / repeating
  patterns) plus noise. Used by CR benchmarks and accuracy-proxy tests so
  compression ratios are meaningful rather than gaussian-worst-case.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def zipf_token_batch(
    rng: np.random.Generator, batch: int, seq: int, vocab: int, alpha: float = 1.1
) -> np.ndarray:
    """[batch, seq] int32 Zipf(alpha) tokens in [0, vocab)."""
    # inverse-CDF sampling on a truncated Zipf for vectorized speed
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random((batch, seq))
    toks = np.searchsorted(cdf, u).astype(np.int32)
    return np.minimum(toks, vocab - 1)


@dataclasses.dataclass
class ShardedTokenStream:
    """Deterministic, restartable, host-sharded token stream.

    Each (host, step) pair maps to an independent RNG stream, so restart
    from a checkpointed ``step`` reproduces the exact same batches and
    different hosts never overlap — the property elastic restarts rely on.
    """

    vocab: int
    batch_per_host: int
    seq: int
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0
    step: int = 0
    alpha: float = 1.1

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, self.step])
        )
        toks = zipf_token_batch(
            rng, self.batch_per_host, self.seq + 1, self.vocab, self.alpha
        )
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])


def synthetic_kv(
    rng: np.random.Generator,
    batch: int,
    heads: int,
    seq: int,
    head_dim: int,
    *,
    channel_scale: float = 2.0,
    smooth: float = 0.95,
    noise: float = 0.15,
    outlier_frac: float = 0.05,
    spike_frac: float = 0.06,
    spike_mag: float = 3.0,
    n_patterns: int = 0,
    pattern_scale: float = 1.0,
    dtype=np.float32,
) -> np.ndarray:
    """KV-like data [B, H, L, D]: per-channel offsets + AR(1) along context
    + sparse token spikes.

    channel_scale: magnitude spread of per-channel means (paper Fig. 4's
      vertical stripes — a few channels dominate the range).
    smooth: AR(1) coefficient along the context dim (token-to-token
      correlation that repacking exploits).
    noise: white-noise floor.
    outlier_frac: fraction of high-variance channels (KV caches have heavy
      per-channel kurtosis; these land in the wide tiers).
    spike_frac/spike_mag: fraction of TOKENS with outlier activations
      (attention sinks, delimiters) — these widen any bit-pack that
      includes them, which is what makes very large pack sizes pay range
      growth (paper Fig. 13's falling tail).
    n_patterns/pattern_scale: tokens draw one of ``n_patterns`` channel-
      mean templates (token categories: code/prose/numbers...). Interleaved
      categories are exactly what encode-aware REPACKING groups — the
      source of the paper's Table I gains.
    """
    ch_mean = rng.normal(0, channel_scale, size=(1, heads, 1, head_dim))
    ch_std = np.full((1, heads, 1, head_dim), noise)
    n_out = max(1, int(outlier_frac * head_dim))
    out_idx = rng.choice(head_dim, size=n_out, replace=False)
    ch_std[..., out_idx] = 1.0
    e = rng.normal(0, 1, size=(batch, heads, seq, head_dim))
    x = np.empty_like(e)
    x[:, :, 0] = e[:, :, 0]
    for t in range(1, seq):
        x[:, :, t] = smooth * x[:, :, t - 1] + np.sqrt(1 - smooth**2) * e[:, :, t]
    # per-token scale mixture (heteroscedastic tokens): larger packs mix
    # more σ regimes, so per-pack ranges grow with pack size even after
    # repacking — the mechanism behind Fig 13's falling tail
    tok_sigma = np.exp(rng.normal(0, 0.5, size=(batch, heads, seq, 1)))
    out = ch_mean + ch_std * tok_sigma * x
    if n_patterns > 0:
        templates = rng.normal(0, pattern_scale,
                               size=(n_patterns, 1, heads, 1, head_dim))
        tok_type = rng.integers(0, n_patterns, size=(batch, heads, seq))
        out = out + np.take_along_axis(
            np.broadcast_to(templates, (n_patterns, batch, heads, seq, head_dim)),
            tok_type[None, ..., None], axis=0,
        )[0]
    if spike_frac > 0:
        spikes = rng.random((batch, heads, seq, 1)) < spike_frac
        out = out + spikes * rng.normal(0, spike_mag * noise,
                                        size=(batch, heads, seq, head_dim))
    return out.astype(dtype)
