"""The recurrent families on the port's SlotServer (mirrors
tests/test_recurrent_slots.py).

rwkv6 and hybrid_rglru decode through O(1) recurrent state (and, for
rglru, window caches) but ride the same slot scheduler as the
transformers: per-slot state insert and reset, per-row positions, free
rows zeroed after every ride-along decode step.

  * Slot outputs are bitwise equal to a B=1 ``Engine.generate`` (admission
    prefills each prompt alone, so a short prompt sharing the table with a
    long one sees no padding); for rglru under packkv, with residual 64,
    the 150-token request's window rings wrap.
  * No left-pad pollution: a 10-token prompt admitted while a 190-token
    one decodes equals its solo run.
  * Chunked admission (64-token cuts, 16-aligned WKV / LRU resume points)
    equals the monolithic admission, bitwise.
  * ``--paged``, ``--prefix-cache``, ``--spec-decode``, ``--preempt`` and
    ``--session-cache`` are refused at engine build with the reference's
    messages, before the parameters are touched; the launcher serves both
    families and refuses ``--session-cache`` as the reference's does."""
import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.serving import engine as je
from repro_torch.configs import get_arch
from repro_torch.core import cache as tc
from repro_torch.models import get_model
from repro_torch.serving import engine as te
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ["rwkv6-1.6b", "recurrentgemma-9b"]


@pytest.fixture(scope="module", params=[("rwkv6-1.6b", "none"),
                                        ("recurrentgemma-9b", "none"),
                                        ("recurrentgemma-9b", "packkv")],
                ids=lambda p: "-".join(p))
def rec_engine(request):
    name, policy = request.param
    cfg = get_arch(name, smoke=True)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    cap = cfg.window if cfg.window else 256
    eng = te.Engine(cfg, params, tc.PackKVConfig(policy=policy, residual=64),
                    te.EngineConfig(capacity=cap, max_batch=2, page_size=64,
                                    device="cpu"))
    return eng, cfg


def _run(eng, reqs):
    srv = te.SlotServer(eng)
    for r in reqs:
        srv.submit(r)
    srv.run()
    return srv


def test_slot_server_matches_b1_generate(rec_engine, rng):
    """Mixed-length requests (several prefill chunks each, co-resident
    decodes, slot reuse) == per-request B=1 generate, bit for bit."""
    eng, cfg = rec_engine
    reqs = [te.Request(rid=0, max_new=70, tokens=rng.integers(0, cfg.vocab, 150)),
            te.Request(rid=1, max_new=9, tokens=rng.integers(0, cfg.vocab, 70)),
            te.Request(rid=2, max_new=4, tokens=rng.integers(0, cfg.vocab, 200))]
    srv = _run(eng, reqs)
    assert srv.stats.slot_reuses >= 1
    assert srv.stats.prefill_chunks >= sum(
        -(-len(r.tokens) // eng.chunk_tokens()) for r in reqs)
    for r in reqs:
        want, state = eng.generate({"tokens": r.tokens[None]}, r.max_new)
        np.testing.assert_array_equal(srv.done[r.rid].output, want[0],
                                      err_msg=f"rid {r.rid}")
        if cfg.window and r.rid == 0:  # 128 prefilled, a flush at step 65
            assert int(state.cache[0].n_comp[0]) == cfg.window + 64
    served = srv.cache
    if cfg.window:
        assert all(int(c.n_comp.abs().sum()) == 0 for c in served.cache)
    assert int(served.pos.abs().sum()) == 0  # free rows zeroed


def test_no_left_pad_pollution(rec_engine, rng):
    """A 10-token prompt admitted while a 190-token prompt decodes in the
    other slot equals its solo run (a batched left-padded prefill would
    push 180 pad tokens through the short row's recurrence)."""
    eng, cfg = rec_engine
    short = rng.integers(0, cfg.vocab, 10)
    long = rng.integers(0, cfg.vocab, 190)
    srv = _run(eng, [te.Request(rid=0, max_new=12, tokens=long),
                     te.Request(rid=1, max_new=12, tokens=short)])
    for rid, toks in ((0, long), (1, short)):
        want, _ = eng.generate({"tokens": toks[None]}, 12)
        np.testing.assert_array_equal(srv.done[rid].output, want[0], err_msg=f"rid {rid}")


def test_chunked_matches_monolithic(rec_engine, rng):
    """prefill_chunk_pages=1 (64-token cuts) == the monolithic admission,
    and a chunked admission's state row equals the monolithic one's."""
    eng, cfg = rec_engine
    mono = te.Engine(cfg, eng.params, eng.pack_cfg,
                     dataclasses.replace(eng.ecfg, prefill_chunk_pages=0,
                                         calibrate=False))
    mk = lambda: [te.Request(rid=i, max_new=5, tokens=rng.integers(0, cfg.vocab, n))
                  for i, n in enumerate((130, 64, 33))]
    st = rng.bit_generator.state
    a = _run(eng, mk())
    rng.bit_generator.state = st
    b = _run(mono, mk())
    assert a.stats.prefill_chunks > 0 and b.stats.prefill_chunks == 0
    for rid in a.done:
        np.testing.assert_array_equal(a.done[rid].output, b.done[rid].output)
    # the row itself: 3 chunks of 64, 64 and 2 tokens against one prefill
    toks = rng.integers(0, cfg.vocab, 130)
    scratch = eng.chunk_init(130)
    for s0 in (0, 64):
        _, scratch = eng.chunk_step(scratch, toks[s0:s0 + 64], s0)
    l_chunk, c_chunk = eng.chunk_final(eng.alloc_slot_cache(), 1, scratch, toks[128:], 128)
    l_mono, c_mono = mono.insert_request(mono.alloc_slot_cache(), 1, toks)
    assert torch.equal(l_chunk, l_mono)
    from repro_torch.utils import tree_flatten

    for x, y in zip(tree_flatten(c_chunk)[0], tree_flatten(c_mono)[0]):
        assert torch.equal(x, y)


FLAGS = [dict(paged=True, prefix_cache=True), dict(paged=True),
         dict(spec_decode=True), dict(preempt=True), dict(session_cache=True)]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f))
def test_refusals_match_reference(name, flags):
    """Each mode the recurrent state cannot serve fails at engine build,
    before the parameters are touched, with the reference's message."""
    with pytest.raises(ValueError) as want:
        je.Engine(j_get_arch(name, smoke=True), None, jc.PackKVConfig(policy="none"),
                  je.EngineConfig(capacity=256, **flags))
    with pytest.raises(ValueError) as got:
        te.Engine(get_arch(name, smoke=True), None, tc.PackKVConfig(policy="none"),
                  te.EngineConfig(capacity=256, device="cpu", **flags))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_recurrent(monkeypatch, name):
    """The launcher serves both families on the CPU, and refuses
    --session-cache with the reference launcher's message."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--arch", name, "--smoke", "--device", "cpu", "--requests",
                           "3", "--max-new", "6", "--prompt-len", "150", "--batch",
                           "2", "--prefill-chunk-pages", "1", "--page-size", "64"]) == 0
    text = out.getvalue()
    assert "3 admitted / 3 completed" in text and "prefill chunks" in text, text
    args = ["--arch", name, "--smoke", "--requests", "1", "--max-new", "2",
            "--prompt-len", "64", "--session-cache"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        serve.main([*args, "--device", "cpu"])
    assert str(got.value) == str(want.value)
