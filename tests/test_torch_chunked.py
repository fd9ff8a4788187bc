"""Chunked admission in the torch port: a prompt admitted in bounded
chunks, one per scheduler step, gives the monolithic admission's logits,
cache bytes and tokens, in dense and paged storage.

  * ``resume_attention`` gives each query row of a chunk the row the
    monolithic ``flash_attention`` computes over the whole prompt,
    bitwise (and the reference's ``resume_attention`` within 1e-5);
  * ``Engine.chunk_init`` / ``chunk_step`` / ``chunk_final`` leave the
    same last-token logits and the same row bytes as ``insert_request``;
  * ``SlotServer`` with ``prefill_chunk_pages`` 1 or 2 gives the tokens
    of ``prefill_chunk_pages`` 0, counting its prefill chunks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.configs import get_arch
from repro_torch.core.cache import PackKVConfig
from repro_torch.models import get_model
from repro_torch.models import layers as tl
from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

torch.set_num_threads(2)


def _chunks(S: int, c: int) -> list[int]:
    return sorted(set(range(0, S, c)) | {S})


@pytest.mark.parametrize("S", [300, 2048])
def test_resume_attention_rows_equal_flash_attention(S):
    """Chunks of 256 queries over the written prefix of the key scratch,
    read to the monolithic kv tiling (``models.transformer.prefill_chunk``'s
    rule): every row bitwise equal to the one-pass ``flash_attention``."""
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.normal(size=(1, 4, S, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, S, 16)).astype(np.float32))
            for _ in range(2))
    want = tl.flash_attention(q, k, v)
    scratch_k, scratch_v = torch.zeros_like(k), torch.zeros_like(v)
    bounds = _chunks(S, 256)
    for s0, s1 in zip(bounds, bounds[1:]):
        scratch_k[:, :, s0:s1], scratch_v[:, :, s0:s1] = k[:, :, s0:s1], v[:, :, s0:s1]
        T = min(S, -(-s1 // min(1024, S)) * min(1024, S))
        got = tl.resume_attention(q[:, :, s0:s1], scratch_k[:, :, :T],
                                  scratch_v[:, :, :T], s0)
        assert torch.equal(got, want[:, :, s0:s1]), (s0, s1)


def test_resume_attention_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 4, 100, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 1024, 16)).astype(np.float32) for _ in range(2))
    k[:, :, 600:] = v[:, :, 600:] = 0  # unwritten scratch past the chunk
    want = jax.jit(jl.resume_attention, static_argnums=3)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 500)
    got = tl.resume_attention(*map(torch.from_numpy, (q, k, v)), 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):  # keys past 1024 must be whole kv tiles
        tl.resume_attention(torch.zeros((1, 1, 4, 8)), torch.zeros((1, 1, 1500, 8)),
                            torch.zeros((1, 1, 1500, 8)), 0)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_arch("llama2-7b", smoke=True)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    return cfg, params


def _engine(smoke, **kw):
    cfg, params = smoke
    base = dict(capacity=2048, max_batch=2, device="cpu", page_size=128)
    return Engine(cfg, params, PackKVConfig(), EngineConfig(**{**base, **kw}))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("S", [129, 300, 2048])
def test_chunked_insert_bit_identical_to_monolithic(smoke, paged, S):
    """128-token chunks (a 2048-token prompt: 16 chunks over two 1024 kv
    tiles) against one prefill: the same last-token logits and every cache
    byte (ledger included) the same."""
    eng = _engine(smoke, paged=paged)
    toks = np.random.default_rng(S).integers(0, smoke[0].vocab, S)
    mono = eng.alloc_slot_cache()
    l_mono, mono = eng.insert_request(mono, 1, toks)
    chunked = eng.alloc_slot_cache()
    bounds = _chunks(S, eng.chunk_tokens())
    scratch = eng.chunk_init(S)
    for s0, s1 in zip(bounds[:-2], bounds[1:-1]):
        _, scratch = eng.chunk_step(scratch, toks[s0:s1], s0)
    l_chunk, chunked = eng.chunk_final(chunked, 1, scratch, toks[bounds[-2]:],
                                       bounds[-2])
    assert torch.equal(l_mono, l_chunk)
    pairs = list(zip(_tensors(mono), _tensors(chunked)))
    assert len(pairs) > 10 and all(torch.equal(a, b) for a, b in pairs)


def _serve(eng, spec, seed=3):
    r = np.random.default_rng(seed)
    srv = SlotServer(eng)
    for i, (n, m) in enumerate(spec):
        srv.submit(Request(rid=i, tokens=r.integers(0, eng.cfg.vocab, n), max_new=m))
    srv.run()
    return srv


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_serving_token_identical_to_monolithic(smoke, paged):
    """Prompts straddling block (64) and page (128) boundaries, some within
    one chunk (the monolithic fast path), under 2 slots with reuse."""
    spec = ((300, 12), (90, 20), (200, 8), (130, 16), (60, 10))
    kw = dict(capacity=512, decode_chunk=4, paged=paged,
              debug_invariants=paged)
    chunked = _serve(_engine(smoke, prefill_chunk_pages=1, **kw), spec)
    mono = _serve(_engine(smoke, prefill_chunk_pages=0, **kw), spec)
    assert chunked.stats.prefill_chunks == 3 + 2 + 2  # 300, 200, 130 tokens
    assert mono.stats.prefill_chunks == 0
    assert chunked.stats.completed == mono.stats.completed == 5
    for rid, req in mono.done.items():
        np.testing.assert_array_equal(chunked.done[rid].output, req.output,
                                      err_msg=f"rid {rid}")


def test_chunk_budget_straddles_page_boundary(smoke):
    """A 2-page budget cuts a 421-token prompt at 256-token marks, so each
    chunk crosses a 128-token page boundary; the tokens match the 1-page
    budget, in half the chunks."""
    spec = ((3 * 128 + 37, 6),)
    two = _serve(_engine(smoke, paged=True, prefill_chunk_pages=2, capacity=512), spec)
    one = _serve(_engine(smoke, paged=True, prefill_chunk_pages=1, capacity=512), spec)
    assert (two.stats.prefill_chunks, one.stats.prefill_chunks) == (2, 4)
    np.testing.assert_array_equal(two.done[0].output, one.done[0].output)
