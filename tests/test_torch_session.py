"""The torch port's multi-turn session cache (park, resume, the host and
disk tiers) and fault plans against the JAX reference and against its
own uninterrupted runs.

  * ``SessionStore`` and ``SwapStore``: one scripted sequence of put /
    match / take / drop / expire under a frozen clock and small budgets
    gives the reference's matches, counters, ``peak_bytes``, LRU victims
    and disk spills and loads; ``save_mini`` / ``load_mini`` round-trip a
    mini bitwise (bf16 leaves included) and refuse an uncommitted
    directory and another structure.
  * ``evacuate_row`` / ``restore_row`` of a row holding two shared-prefix
    pages byte-exact with the reference's (split from
    ``tests/test_torch_preempt.py`` to balance the two files).
  * ``SlotServer`` sessions, port against itself (backend ``fused``: the
    plain kernel versions on the CPU), over {packkv, none} x {dense,
    paged, prefix}: a session hit is bitwise equal to the uninterrupted
    control chain and runs no prefill chunk; the host counter mirror
    equals the device counters after every step; a 3-resume chain, the
    disk tier, TTL expiry degrading to a cold admission, a shared-prefix
    park, a session row preempted mid-ingestion, a speculative server's
    hit, a ``FaultPlan`` of every kind (the run drains, no page leaks,
    untouched requests equal their control), the sliding-window refusal.
    Every control runs at the server's ``max_batch`` and ``spec_k``.
  * Port against reference: dense packkv, one session chain through both
    ``SlotServer``s gives equal counters and tokens equal under the
    margin rule.
  * ``launch/serve.py --session-cache --stats-json`` runs.

Mirrors ``tests/test_session_cache.py``. The reference runs compiled
without excess precision (``torch_port_helpers.EXACT``)."""
import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import sharded as jsharded
from repro.core import cache as jc
from repro.data import synthetic_kv
from repro.serving import engine as je
from repro_torch.checkpoint import load_mini, save_mini
from repro_torch.core import cache as tc
from repro_torch.distributed import FaultEvent, FaultPlan
from repro_torch.serving import engine as te
from repro_torch.utils import tree_flatten
from test_torch_preempt import (
    PAGE,
    _appends,
    _bf16,
    _configs,
    _engine,
    _evacuate,
    _insert,
    _jengine,
    _restore,
    _sched_stats,
    smoke,  # noqa: F401  (the module-scoped fixture)
)
from torch_port_helpers import assert_cache_equal, jit_exact, ref_cache_to_torch, steps_before_tie

torch.set_num_threads(2)

B, H, D = 3, 2, 64


# ---------------------------------------------------------------------------
# the stores and the disk serializers against the reference
# ---------------------------------------------------------------------------


def _minis(n: int, fill: int):
    """A mini of ``n + 4`` bytes in each package: (port, reference)."""
    port = {"a": torch.full((n,), fill, dtype=torch.uint8),
            "b": torch.tensor([1.5, -fill], dtype=torch.bfloat16)}
    ref = {"a": np.full((n,), fill, np.uint8),
           "b": np.asarray([1.5, -fill], np.float32).astype(ml_dtypes.bfloat16)}
    return port, ref


def _store_state(st):
    return (st.parks, st.hits, st.evictions, st.expired, st.spills, st.loads,
            st.peak_bytes, st.nbytes, len(st), sorted(st._host), sorted(st._disk))


def test_session_store_matches_reference(tmp_path):
    """Puts of several sizes into a 100-byte host tier with a disk tier
    and a 50 s TTL, matches (longest parked prefix), takes (from host and
    disk), a re-park, a drop, a clock jump past the TTL, expire_now and
    traces: the same keys, minis, counters and LRU victims."""
    now = [0.0]
    clock = lambda: now[0]
    stores = (tc.SessionStore(100, ttl_s=50.0, disk_dir=str(tmp_path / "p"), clock=clock),
              jc.SessionStore(100, ttl_s=50.0, disk_dir=str(tmp_path / "r"), clock=clock))
    for d in ("p", "r"):
        os.makedirs(tmp_path / d)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 1000, 40)
    log = ([], [])
    script = [("put", 10, 30), ("put", 14, 40), ("put", 20, 36), ("match", 25),
              ("put", 12, 20), ("match", 16), ("take", 14), ("put", 30, 60),
              ("match", 40), ("take", 30), ("put", 10, 24), ("drop", 20),
              ("tick", 30.0), ("put", 8, 10), ("match", 12), ("tick", 25.0),
              ("match", 40), ("put", 16, 8), ("put", 18, 8), ("expire", 1),
              ("traces", 3), ("match", 40), ("take", -1)]
    for op in script:
        if op[0] == "tick":
            now[0] += op[1]
            continue
        for st, out, is_port in ((stores[0], log[0], True), (stores[1], log[1], False)):
            if op[0] == "put":
                mini = _minis(op[2], op[1])[0 if is_port else 1]
                st.put(base[:op[1]], mini, {"len": op[1]})
            elif op[0] == "match":
                out.append(st.match(base[:op[1]]))
            elif op[0] == "take":
                key = st.match(base) if op[1] < 0 else st.key_of(base[:op[1]])
                if key is None:
                    out.append(None)
                    continue
                mini, meta = st.take(key)
                b = mini["b"]
                b = b.float().tolist() if is_port else np.asarray(b, np.float32).tolist()
                out.append((meta, np.asarray(mini["a"]).tolist(), b))
            elif op[0] == "drop":
                st.drop(st.key_of(base[:op[1]]))
            elif op[0] == "expire":
                out.append(st.expire_now(op[1]))
            elif op[0] == "traces":
                out.append([t.tolist() for t in st.traces(op[1])])
            out.append(_store_state(st))
    assert log[0] == log[1]
    st = stores[0]
    assert st.spills >= 2 and st.loads >= 1 and st.expired >= 2 and st.evictions >= 1


def test_swap_store_matches_reference():
    got, want = tc.SwapStore(), jc.SwapStore()
    for st, ref in ((got, False), (want, True)):
        for rid, n in ((3, 40), (5, 10), (9, 24)):
            st.put(rid, _minis(n, rid)[int(ref)], {"rid": rid})
        st.pop(5)
        st.drop(3)
        st.put(5, _minis(7, 5)[int(ref)], {"rid": 5})
    for attr in ("swapped_out", "swapped_in", "peak_bytes", "nbytes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert len(got) == len(want) == 2 and 9 in got and 3 not in got
    assert [m["rid"] for m in got.metas()] == [m["rid"] for m in want.metas()]


def _smoke_mini(smoke):
    """A port mini of the smoke model (every leaf kind: int32 payloads,
    int8 mins, uint8 shifts, f32 scales, bf16 residuals, int32 counters)."""
    eng = _engine(smoke, "packkv", "paged")
    cache = eng.alloc_slot_cache()
    toks = np.random.default_rng(1).integers(0, smoke[2].vocab, 200)
    _, cache = eng.insert_request(cache, 0, toks)
    return eng.evacuate(cache, 0, 2)[1]


def test_save_load_mini_bitwise(smoke, tmp_path):
    mini = _smoke_mini(smoke)
    leaves, treedef = tree_flatten(mini)
    assert any(x.dtype == torch.bfloat16 for x in leaves)
    path = save_mini(str(tmp_path / "m"), mini, extra={"rid": 7})
    assert sorted(os.listdir(path)) == ["COMMIT", "arrays.npz", "manifest.json"]
    back, extra = load_mini(path, treedef)
    assert extra == {"rid": 7}
    for a, b in zip(leaves, tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    flat, _ = load_mini(path)
    assert len(flat) == len(leaves)
    # the reference's grammar: its loader reads the port's arrays
    ref_leaves, _ = jsharded.load_mini(path)
    assert [np.asarray(x).shape for x in ref_leaves] == [tuple(x.shape) for x in leaves]
    other = tree_flatten(mini[:1])[1]
    with pytest.raises(ValueError, match="structure mismatch"):
        load_mini(path, other)
    os.remove(os.path.join(path, "COMMIT"))
    with pytest.raises(FileNotFoundError):
        load_mini(path, treedef)


def test_evacuate_restore_shared_prefix_byte_exact():
    """Row 0 (300 tokens: 2 pages) is pinned by an index reference; row 2
    maps those 2 pages by reference and owns a third (insert_row_paged
    with shared pages). Evacuating row 2 copies only its owned page and
    releases its shared references; evacuating row 0 leaves the pinned
    pages alive; row 2's mini restored into slot 0 maps them back. Every
    step byte-exact with the reference's."""
    cap = 512
    jcfg, tcfg, fma = _configs("packkv", True, cap)
    rng = np.random.default_rng(5)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, cap)
    for r, n in ((0, 300), (1, 131)):
        kv = jnp.asarray(_bf16(synthetic_kv(rng, 1, H, n, D))[0])
        jcache = _insert(jcache, r, kv, kv[:, ::-1])
    shared = np.asarray(jcache.pages.page_table[0, :2])
    jcache = jit_exact(jc.acquire_pages)(jcache, jnp.asarray(shared))
    # row 2: a 400-token prompt compressed densely, its first 2 pages shared
    kv = jnp.asarray(_bf16(synthetic_kv(rng, 1, H, 400, D)))
    dcfg = dataclasses.replace(jcfg, paged=False)
    row = jit_exact(jc.prefill_cache)(jc.alloc_layer_cache(dcfg, 1, H, D, 3 * PAGE), kv, kv)
    jcache = jit_exact(jc.insert_row_paged, static_argnames=("n_pages", "n_shared"))(
        jcache, 2, row, n_pages=3, n_shared=2, shared_phys=jnp.asarray(shared))
    tcache = ref_cache_to_torch(jcache, tcfg)
    jcache = _appends(jcache, tcache, rng, 20)
    assert_cache_equal(tcache, jcache, fma)
    assert [int(tcache.pages.ref[p]) for p in shared] == [3, 3]
    jcache, jmini = _evacuate(jcache, 2, n_pages=3, n_shared=2)
    tcache, tmini = tc.evacuate_row(tcache, 2, 3, 2)
    assert tmini.k.scale.shape[-1] == PAGE  # only the owned page was copied
    assert_cache_equal(tmini, jmini, fma)
    assert_cache_equal(tcache, jcache, fma)
    assert [int(tcache.pages.ref[p]) for p in shared] == [2, 2]
    jcache, jmini0 = _evacuate(jcache, 0, n_pages=2)
    tcache, tmini0 = tc.evacuate_row(tcache, 0, 2)
    assert_cache_equal(tmini0, jmini0, fma)
    assert [int(tcache.pages.ref[p]) for p in shared] == [1, 1]  # the pin
    phys = torch.from_numpy(shared.astype(np.int32))
    jcache = _restore(jcache, 0, jmini, jnp.asarray(shared), n_pages=3, n_shared=2)
    tc.restore_row(tcache, 0, tmini, phys, 3, 2)
    assert_cache_equal(tcache, jcache, fma)
    np.testing.assert_array_equal(tcache.pages.page_table[0, :2].numpy(), shared)
    jcache = _appends(jcache, tcache, rng, 70)  # slot 0 flushes into a new page
    assert int(tcache.n_comp[0]) == 448
    assert_cache_equal(tcache, jcache, fma)




# ---------------------------------------------------------------------------
# serving: a session hit == the uninterrupted chain (the port against itself)
# ---------------------------------------------------------------------------


def _step_checked(srv):
    """One scheduler step, then every occupied row's host counter mirror
    against the device counters."""
    out = srv.step()
    for i, act in enumerate(srv.slots):
        if act is not None:
            c = srv.cache[0]
            assert srv._counters(act) == (int(c.n_comp[i]), int(c.n_resid[i])), (i, act.base)
    return out


def _run(srv):
    while srv.queue or srv.n_occupied or srv._task is not None:
        _step_checked(srv)


def _control_chain(src: te.Engine, prompt, turns):
    """The whole conversation driven by hand, uninterrupted, on a
    session-off engine of the same config (the same ``max_batch`` and
    ``spec_k``: the decode GEMMs' height), row 0 live and the others
    free: ``turns`` is ``[(ext, max_new), ...]``, ``ext`` None for turn 1.
    Returns one output list a turn."""
    base = te.Engine(src.cfg, src.params, src.pack_cfg, dataclasses.replace(
        src.ecfg, session_cache=False, preempt=False, calibrate=False,
        spec_decode=False))
    n = base.ecfg.max_batch
    active = [True] + [False] * (n - 1)
    cache = base.alloc_slot_cache()
    if base.ecfg.prefix_cache:
        logits, cache = base.insert_request_prefix(cache, 0, prompt, [], None)
    else:
        logits, cache = base.insert_request(cache, 0, prompt)

    def step(tok):
        toks = np.zeros((n, 1), np.int32)
        toks[0, 0] = tok
        lg, c = base.decode(cache, toks)
        return int(torch.argmax(lg[0])), base.mask_free(c, active)

    t, outs = int(torch.argmax(logits)), []
    for ext, max_new in turns:
        if ext is not None:
            for f in [outs[-1][-1]] + [int(x) for x in ext[:-1]]:
                _, cache = step(f)
            t, cache = step(int(ext[-1]))
        out = [t]
        for _ in range(max_new - 1):
            t, cache = step(t)
            out.append(t)
        outs.append(out)
    return outs


def _turns(srv, prompt, plan, rid0=0, **kw):
    """Serve a conversation turn by turn on ``srv``; returns the outputs."""
    outs, toks = [], prompt
    for k, (ext, max_new) in enumerate(plan):
        if ext is not None:
            toks = np.concatenate([toks, np.asarray(outs[-1]), ext])
        srv.submit(te.Request(rid=rid0 + k, max_new=max_new, tokens=toks, **kw))
        _run(srv)
        outs.append(list(srv.done[rid0 + k].output))
    return outs


@pytest.mark.parametrize("mode", ["dense", "paged", "prefix"])
@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_session_hit_bit_identical(smoke, policy, mode):
    eng = _engine(smoke, policy, mode, session_cache=True)
    srv = te.SlotServer(eng)
    r = np.random.default_rng(5)
    prompt, ext = r.integers(0, smoke[2].vocab, 200), r.integers(0, smoke[2].vocab, 5)
    out1 = _turns(srv, prompt, [(None, 8)])[0]
    assert srv.stats.session_parks == 1
    chunks = srv.stats.prefill_chunks
    srv.submit(te.Request(rid=1, max_new=6, tokens=np.concatenate([prompt, out1, ext])))
    _run(srv)
    s = srv.stats
    assert s.session_hits == 1 and s.session_lookups == 2
    assert s.prefill_chunks == chunks  # no forward pass over the parked rows
    assert (s.session_restored_pages > 0) == (mode != "dense")
    req = srv.done[1]
    assert req.t_first is not None and len(req.token_times) == 6
    assert (out1, list(req.output)) == tuple(_control_chain(eng, prompt, [(None, 8), (ext, 6)]))


def test_session_three_resume_chain(smoke):
    eng = _engine(smoke, "packkv", "paged", session_cache=True)
    srv = te.SlotServer(eng)
    r = np.random.default_rng(7)
    prompt = r.integers(0, smoke[2].vocab, 150)
    plan = [(None, 6), (r.integers(0, smoke[2].vocab, 4), 4),
            (r.integers(0, smoke[2].vocab, 1), 5), (r.integers(0, smoke[2].vocab, 3), 4)]
    outs = _turns(srv, prompt, plan)
    assert srv.stats.session_parks == 4 and srv.stats.session_hits == 3
    assert srv.stats.session_hit_rate == 0.75
    assert outs == _control_chain(eng, prompt, plan)


def test_session_disk_tier_roundtrip(smoke, tmp_path):
    """A 1-byte host tier sends the park straight to disk; the returning
    session loads it back and is still bitwise equal to the chain."""
    store = tc.SessionStore(capacity_bytes=1, disk_dir=str(tmp_path))
    eng = _engine(smoke, "packkv", "paged", session_cache=True)
    srv = te.SlotServer(eng, session_store=store)
    r = np.random.default_rng(9)
    prompt, ext = r.integers(0, smoke[2].vocab, 180), r.integers(0, smoke[2].vocab, 4)
    out1 = _turns(srv, prompt, [(None, 8)])[0]
    assert store.spills == 1 and len(store._host) == 0 and len(store._disk) == 1
    srv.submit(te.Request(rid=1, max_new=6, tokens=np.concatenate([prompt, out1, ext])))
    _run(srv)
    assert store.loads == 1 and srv.stats.session_hits == 1
    assert [out1, list(srv.done[1].output)] == _control_chain(
        eng, prompt, [(None, 8), (ext, 6)])


def test_session_ttl_expiry_degrades_to_cold(smoke):
    now = [0.0]
    store = tc.SessionStore(ttl_s=10.0, clock=lambda: now[0])
    eng = _engine(smoke, "none", "dense", session_cache=True)
    srv = te.SlotServer(eng, session_store=store)
    r = np.random.default_rng(3)
    prompt, ext = r.integers(0, smoke[2].vocab, 150), r.integers(0, smoke[2].vocab, 4)
    out1 = _turns(srv, prompt, [(None, 6)])[0]
    assert len(store) == 1
    now[0] = 11.0  # the park is stale
    srv.submit(te.Request(rid=1, max_new=5, tokens=np.concatenate([prompt, out1, ext])))
    _run(srv)
    assert store.expired == 1 and srv.stats.session_hits == 0
    assert srv.stats.session_evictions == 1 and srv.done[1].status == "done"
    # policy none is lossless: the cold admission equals the chain
    assert (out1, list(srv.done[1].output)) == tuple(
        _control_chain(eng, prompt, [(None, 6), (ext, 5)]))


def test_session_shared_prefix_park(smoke):
    """A parked row whose prefix pages the index holds maps them back by
    reference on return: only its owned pages stream back."""
    eng = _engine(smoke, "packkv", "prefix", session_cache=True)
    srv = te.SlotServer(eng)
    r = np.random.default_rng(11)
    v = smoke[2].vocab
    sys_p = r.integers(0, v, 2 * PAGE)
    a = np.concatenate([sys_p, r.integers(0, v, 40)])
    b = np.concatenate([sys_p, r.integers(0, v, 53)])
    _turns(srv, a, [(None, 6)])
    out_b = _turns(srv, b, [(None, 6)], rid0=1)[0]
    assert srv.stats.session_parks == 2 and srv.stats.prefix_hits == 1
    trace_b = np.concatenate([b, out_b])
    meta = srv._sessions.meta(srv._sessions.match(trace_b))
    assert meta["n_shared"] == 2
    before = srv.stats.session_restored_pages
    ext = r.integers(0, v, 4)
    srv.submit(te.Request(rid=2, max_new=5, tokens=np.concatenate([trace_b, ext])))
    _run(srv)
    assert srv.stats.session_hits == 1
    assert srv.stats.session_restored_pages - before == meta["n_pages"] - meta["n_shared"]
    ctl = _control_chain(eng, b, [(None, 6), (ext, 5)])
    assert [out_b, list(srv.done[2].output)] == ctl


def test_session_row_preempted_mid_ingestion(smoke):
    """A returning turn (class 1) is swapped out by a class-0 arrival
    while it still ingests its 24-token suffix: the swap keeps its forced
    queue and counter anchor, the host mirror equals the device counters
    throughout, and the turn's tokens equal the chain's."""
    eng = _engine(smoke, "packkv", "paged", session_cache=True, preempt=True)
    srv = te.SlotServer(eng)
    r = np.random.default_rng(13)
    v = smoke[2].vocab
    prompt, ext = r.integers(0, v, 200), r.integers(0, v, 24)
    out1 = _turns(srv, prompt, [(None, 6)], priority=1)[0]
    srv.submit(te.Request(rid=5, max_new=40, tokens=r.integers(0, v, 90)))
    turn2 = te.Request(rid=1, max_new=6, priority=1,
                       tokens=np.concatenate([prompt, out1, ext]))
    srv.submit(turn2)
    while not (turn2.status == "active" and srv.stats.session_hits == 1):
        _step_checked(srv)
    for _ in range(4):
        _step_checked(srv)
    act = next(a for a in srv.slots if a is not None and a.req is turn2)
    assert 0 < len(act.forced) < 24  # mid-ingestion
    srv.submit(te.Request(rid=6, max_new=4, tokens=r.integers(0, v, 70)))
    _run(srv)
    assert turn2.n_preempts == 1 and srv.stats.preemptions == 1
    assert srv.stats.swapped_pages == srv.stats.restored_pages
    assert list(turn2.output) == _control_chain(eng, prompt, [(None, 6), (ext, 6)])[1]


class _Junk:
    """A drafter that always proposes k copies of one token: every pass
    verifies, drafts rarely survive, outputs must not move."""

    def seed(self, slot, tokens):
        pass

    def extend(self, slot, tokens):
        pass

    def drop(self, slot):
        pass

    def draft(self, slot, k):
        return [7] * k


def test_spec_session_hit_equals_plain(smoke):
    """A speculative server's session hit rides the verify passes
    seed-only while it ingests: the same tokens as a plain server's."""
    plain = _engine(smoke, "packkv", "dense", session_cache=True, spec_k=3)
    spec = te.Engine(plain.cfg, plain.params, plain.pack_cfg, dataclasses.replace(
        plain.ecfg, calibrate=False, spec_decode=True, spec_backoff=0))
    r = np.random.default_rng(17)
    v = smoke[2].vocab
    prompt, ext = r.integers(0, v, 180), r.integers(0, v, 6)
    plan = [(None, 8), (ext, 8)]
    a = _turns(te.SlotServer(plain), prompt, plan)
    srv = te.SlotServer(spec, drafter=_Junk())
    assert _turns(srv, prompt, plan) == a
    assert srv.stats.session_hits == 1 and srv.stats.spec_launches > 0


def test_fault_plan_run_drains(smoke):
    """The paged prefix engine with sessions and preemption under a plan
    of every fault kind over its first 40 steps, 8 requests: the run
    drains, the ledger conserves references after every admit and retire
    (debug_invariants), every page is back but the index's, the swap
    store is empty, and every request no fault touched equals its control."""
    eng = _engine(smoke, "packkv", "prefix", session_cache=True, preempt=True)
    v = smoke[2].vocab
    r = np.random.default_rng(19)
    sys_p = r.integers(0, v, PAGE)
    reqs = lambda: [te.Request(rid=i, max_new=int(r2.integers(24, 48)), priority=i % 2,
                               tokens=np.concatenate([sys_p, r2.integers(0, v, int(n))]))
                    for r2 in [np.random.default_rng(23)]
                    for i, n in enumerate(r2.integers(40, 300, 8))]
    plan = FaultPlan([FaultEvent(3, "chunk_abort"), FaultEvent(5, "pool_squeeze", 3),
                      FaultEvent(9, "park", 1), FaultEvent(11, "pool_squeeze", 0),
                      FaultEvent(12, "resume", 1), FaultEvent(16, "cancel", 1),
                      FaultEvent(20, "park", 1), FaultEvent(22, "session_expire", 1),
                      FaultEvent(25, "deadline", 1), FaultEvent(28, "resume", 2),
                      FaultEvent(33, "chunk_abort"), FaultEvent(38, "straggler", 5.0)])
    srv = te.SlotServer(eng, fault_plan=plan)
    for q in reqs():
        srv.submit(q)
    srv.run()
    assert len(plan.fired) == len(plan.events), srv._step_no
    s = srv.stats
    assert s.cancelled >= 1 and s.expired >= 1 and s.session_parks >= 2
    assert srv.queue == [] and srv._task is None and len(srv._swap) == 0
    for layer in srv.cache:
        assert int(layer.pages.n_free) == layer.pages.n_pool_pages - srv._index.n_held
    touched = {rid for rid, q in srv.done.items() if q.status != "done"}
    ctl = te.SlotServer(_engine(smoke, "packkv", "prefix"))
    for q in reqs():
        ctl.submit(q)
    ctl.run()
    compared = 0
    for rid, q in ctl.done.items():
        if rid not in touched:
            np.testing.assert_array_equal(srv.done[rid].output, q.output, err_msg=f"rid {rid}")
            compared += 1
    assert compared >= 4 and len(touched) >= 3


def test_session_rejects_sliding_window(smoke):
    _, _, tcfg, tparams = smoke
    with pytest.raises(ValueError, match="sliding-window"):
        te.Engine(dataclasses.replace(tcfg, window=128), tparams, tc.PackKVConfig(policy="none"),
                  te.EngineConfig(capacity=256, max_batch=2, device="cpu", calibrate=False,
                                  session_cache=True))


# ---------------------------------------------------------------------------
# against the reference, and the CLI
# ---------------------------------------------------------------------------


def test_session_scheduler_matches_reference(smoke):
    """Dense packkv, monolithic admission: a three-turn chain through both
    SlotServers gives equal counters and tokens equal until the port's
    first near-tie (the margin rule, over each turn's whole prompt)."""
    cfg, _, tcfg, _ = smoke
    kw = dict(session_cache=True, prefill_chunk_pages=0)
    eng = _engine(smoke, "packkv", "dense", **kw)
    r = np.random.default_rng(29)
    prompt = r.integers(0, tcfg.vocab, 160)
    plan = [(None, 6), (r.integers(0, tcfg.vocab, 5), 5), (r.integers(0, tcfg.vocab, 2), 6)]
    a = te.SlotServer(eng)
    outs = _turns(a, prompt, plan)
    b = je.SlotServer(_jengine(smoke, eng, **kw))
    toks, compared = prompt, 0
    for k, (ext, max_new) in enumerate(plan):
        if ext is not None:
            toks = np.concatenate([toks, np.asarray(outs[k - 1]), ext])
        b.submit(je.Request(rid=k, max_new=max_new, tokens=toks))
        b.run()
        _, n = steps_before_tie(eng, toks, max_new)
        np.testing.assert_array_equal(outs[k][:n], np.asarray(b.done[k].output)[:n])
        compared += n
    assert compared >= 8, compared
    assert a.stats.session_hits == 2
    assert _sched_stats(a.stats) == _sched_stats(b.stats)


def test_serve_cli_session_cache(tmp_path):
    from repro_torch.launch import serve

    path = tmp_path / "stats.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                           "--session-cache", "--stats-json", str(path), "--requests", "3",
                           "--max-new", "6", "--prompt-len", "96", "--batch", "2",
                           "--capacity", "256"]) == 0
    text = out.getvalue()
    assert "session cache:" in text and "returning sessions" in text, text
    stats = json.loads(path.read_text())
    assert stats["session_hits"] == 3 and stats["session_hit_rate"] == 0.5
    assert {"occupancy", "decode_tok_s", "acceptance_rate", "prefix_hit_rate"} <= stats.keys()
