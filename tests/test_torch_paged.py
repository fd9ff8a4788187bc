"""The torch port's paged storage (page pool, page ledger, K5's plain
version, paged serving) against the JAX reference and against the port's
own dense storage.

  * Ledger: the same operations (whole-batch prefill, appends whose
    flushes cross page boundaries, reset, re-insert, a masked free row, a
    copy-on-write flush through ``pool_acquire_ids``, the capacity cap)
    leave the page table, free stack, ``n_free``, ``ref`` and every pool
    leaf byte-exact with the reference's.
  * Reads: ``gather_paged`` equals the dense cache's bytes; K5's plain
    version is within rtol 1e-5 / atol 1e-4 of the reference's
    ``paged_decode_attention(backend="xla")`` and bitwise equal to K2's
    plain version on the gathered view, at page sizes 64, 256 and 512.
  * Serving: paged and dense serving give the same tokens in the port;
    on an oversubscribed pool the port's scheduler admits in the
    reference's order with the same blocks and reservation peak; the
    paged submit rejections raise as the reference's do.

The reference runs compiled without excess precision
(``torch_port_helpers.EXACT``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.data import synthetic_kv
from repro.kernels import ops as jops
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.kernels import ops
from repro_torch.kernels.packed_attention import (
    fused_packed_attention_paged,
    fused_packed_attention_paged_torch,
    fused_packed_attention_torch,
)
from torch_port_helpers import (
    LOGIT_ATOL,
    assert_cache_equal,
    jit_exact,
    margin,
    ref_cache_to_torch,
    steps_before_tie,
)

torch.set_num_threads(2)

B, H, D = 3, 2, 32
# the reference's paged read, compiled (f32 math: compiling changes no
# rounding these tolerances could see; op by op it takes seconds)
j_paged_attention = jax.jit(
    lambda q, c, sm, n_bucket: jops.paged_decode_attention(
        q, c, sm, n_bucket=n_bucket, backend="xla"),
    static_argnames=("sm", "n_bucket"))
TOL = dict(rtol=1e-5, atol=1e-4)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _configs(policy="packkv", **paged):
    """(reference config, port config) with the same fields, calibrated
    specs for packkv."""
    jcfg = jc.PackKVConfig(policy=policy, **paged)
    if policy == "packkv":
        k = _bf16(synthetic_kv(np.random.default_rng(7), 1, H, 128, D))
        jcfg = jc.calibrate_specs(jnp.asarray(k), jnp.asarray(k), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tc.PackKVConfig)}
    for name in ("k_spec_static", "v_spec_static"):
        s = fields[name]
        if s is not None:
            fields[name] = tc.TierSpec(s.widths, s.counts, s.pack_size)
    return jcfg, tc.PackKVConfig(**fields)


def _fma_c(cfg):
    return ((cfg.k_quant().max_q + 1) // 2, (cfg.v_quant().max_q + 1) // 2)


def _conserved(pool):
    """free <=> ref == 0, both ways (the reference's invariant)."""
    ref = pool.ref.numpy()
    nf = int(pool.n_free)
    assert int((ref == 0).sum()) == nf and int((ref > 0).sum()) + nf == len(ref)
    assert (ref[pool.free.numpy()[:nf]] == 0).all()


# ---------------------------------------------------------------------------
# the ledger and the pool bytes after identical operations
# ---------------------------------------------------------------------------

CAP, PAGE, POOL = 256, 128, 8


def _page_bytes(cache, page):
    """Every pool leaf's bytes of one physical page."""
    return [np.asarray(a)[:, page] for a in jax.tree_util.tree_leaves(
        (cache.k, cache.v, cache.raw_k, cache.raw_v))
        if np.ndim(a) >= 3 and np.shape(a)[1] == POOL]


@pytest.mark.parametrize("policy", ["packkv", "none"])
def test_pool_ledger_byte_exact(policy):
    jcfg, tcfg = _configs(policy, paged=True, page_size=PAGE, pool_pages=POOL)
    fma = _fma_c(jcfg) if policy != "none" else None
    rng = np.random.default_rng(11)
    T = lambda a: tensor_from_numpy(a, "cpu")
    prompt = _bf16(synthetic_kv(rng, B, H, 150, D))
    row1 = _bf16(synthetic_kv(rng, 1, H, 70, D))[0]
    row2 = _bf16(synthetic_kv(rng, 1, H, 40, D))[0]
    steps = _bf16(rng.normal(size=(260, B, H, 1, D)) * 2.0)

    prefill = jit_exact(jc.prefill_cache)
    insert = jit_exact(jc.insert_prefill)
    append = jit_exact(jc.append_token)
    reset = jit_exact(jc.reset_slot)
    mask = jit_exact(jc.mask_free_slots)
    pool_op = lambda c, f, ids: dataclasses.replace(
        c, pages=f(c.pages, jnp.asarray(ids, jnp.int32)))

    jcache = prefill(jc.alloc_layer_cache(jcfg, B, H, D, CAP),
                     jnp.asarray(prompt), jnp.asarray(prompt[:, ::-1]))
    tcache = tc.prefill_cache(tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu"),
                              T(prompt), T(np.ascontiguousarray(prompt[:, ::-1])))
    assert_cache_equal(tcache, jcache, fma)
    jcache = insert(reset(jcache, 2), 2, jnp.asarray(row2), jnp.asarray(row2))
    tc.insert_prefill(tc.reset_slot(tcache, 2), 2, T(row2), T(row2))
    active = np.ones(B, bool)
    cow_page = None
    for i in range(len(steps)):
        if i == 80:  # recycle slot 1 with a new request
            jcache = insert(reset(jcache, 1), 1, jnp.asarray(row1), jnp.asarray(row1))
            tc.insert_prefill(tc.reset_slot(tcache, 1), 1, T(row1), T(row1))
        if i == 140:  # slot 2 retires; its free row rides along, re-zeroed
            jcache, active[2] = reset(jcache, 2), False
            tc.reset_slot(tcache, 2)
        if i == 200:  # ... and takes a new request
            jcache, active[2] = insert(jcache, 2, jnp.asarray(row1), jnp.asarray(row1)), True
            tc.insert_prefill(tcache, 2, T(row1), T(row1))
        n0 = int(jcache.n_comp[0])
        if cow_page is None and n0 % PAGE and int(jcache.n_resid[0]) == 100:
            # another holder pins row 0's half-full page: its next flush
            # must copy it to a private page (copy-on-write)
            cow_page = int(jcache.pages.page_table[0, n0 // PAGE])
            jcache = pool_op(jcache, jc.pool_acquire_ids, [cow_page])
            tc.pool_acquire_ids(tcache.pages, torch.tensor([cow_page]))
            pinned = _page_bytes(jcache, cow_page)
        k, v = steps[i], steps[(i * 7) % len(steps)]
        jcache = append(jcache, jnp.asarray(k), jnp.asarray(v))
        tc.append_token(tcache, T(k), T(v))
        if not active.all():
            jcache = mask(jcache, jnp.asarray(active))
            tc.mask_free_slots(tcache, torch.from_numpy(active))
        if i in (79, 139, 199):
            assert_cache_equal(tcache, jcache, fma)
            _conserved(tcache.pages)
    assert cow_page is not None
    # the pinned page kept its bytes and is now held by the pin alone
    assert int(tcache.pages.ref[cow_page]) == 1
    assert cow_page not in tcache.pages.page_table[0].tolist()
    for a, b in zip(pinned, _page_bytes(jcache, cow_page)):
        np.testing.assert_array_equal(a, b)
    jcache = pool_op(jcache, jc._pool_release_ids, [cow_page, POOL])
    tc._pool_release_ids(tcache.pages, torch.tensor([cow_page, POOL]))
    assert_cache_equal(tcache, jcache, fma)
    _conserved(tcache.pages)
    # row 0 reached capacity and stopped flushing (the paged cap)
    assert int(tcache.n_comp[0]) == CAP and int(tcache.n_resid[0]) > tcfg.residual


# ---------------------------------------------------------------------------
# reads: the gathered view and K5's plain version
# ---------------------------------------------------------------------------


def _paged_pair(page, lengths, cap=1024, G=2):
    """A reference paged cache with rows of ``lengths`` tokens (0 = an
    empty row), inserted in shuffled slot order so page ids are not in
    row order, and its port twin."""
    jcfg, tcfg = _configs(paged=True, page_size=page)
    rng = np.random.default_rng(page)
    jcache = jc.alloc_layer_cache(jcfg, B, H, D, cap)
    insert = jit_exact(jc.insert_prefill)
    for r in (2, 0, 1):
        if lengths[r]:
            kv = jnp.asarray(_bf16(synthetic_kv(rng, 1, H, lengths[r], D))[0])
            jcache = insert(jcache, r, kv, kv[:, ::-1])
    q = rng.normal(size=(B, H * G, D)).astype(np.float32)
    return jcache, ref_cache_to_torch(jcache, tcfg), q


@pytest.mark.parametrize("page,n_bucket", [(64, None), (256, 512), (512, None)])
def test_k5_plain_matches_reference_and_k2_on_gathered_view(page, n_bucket):
    """Ragged rows (one empty), full-capacity and bucketed reads."""
    lengths = (1000, 0, 300)
    jcache, tcache, q = _paged_pair(page, lengths)
    sm = D ** -0.5
    want = j_paged_attention(jnp.asarray(q), jcache, sm, n_bucket=n_bucket)
    got = ops.paged_decode_attention(torch.from_numpy(q), tcache, sm,
                                     n_bucket=n_bucket, backend="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref_path = ops.paged_decode_attention(torch.from_numpy(q), tcache, sm,
                                          n_bucket=n_bucket, backend="ref")
    np.testing.assert_allclose(ref_path.numpy(), np.asarray(want), **TOL)
    n_tok = n_bucket or tcache.capacity
    n = torch.clamp(tcache.n_comp, max=n_tok)
    paged = fused_packed_attention_paged(
        torch.from_numpy(q), tcache.k, tcache.v, tcache.pages.page_table, n,
        n_tok, sm, page_size=page)
    view = tc.gather_paged(tcache, n_bucket)
    dense = fused_packed_attention_torch(torch.from_numpy(q), view.k, view.v,
                                         n, sm, tile_l=min(256, page))
    for a, b in zip(paged, dense):  # K5's tile is min(256, page_size)
        assert torch.equal(a, b)
    # the empty row: zero partials and m = -1e30
    o, m, l = paged
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()


def test_gather_paged_equals_dense_bytes():
    """The same inserts and appends into a dense and a paged cache: the
    gathered view holds the dense bytes on every live token."""
    _, tcfg = _configs(paged=True, page_size=PAGE)
    dcfg = dataclasses.replace(tcfg, paged=False)
    rng = np.random.default_rng(3)
    dense = tc.alloc_layer_cache(dcfg, B, H, D, CAP, device="cpu")
    paged = tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu")
    for r, n in enumerate((200, 64, 10)):
        kv = torch.from_numpy(np.ascontiguousarray(
            _bf16(synthetic_kv(rng, 1, H, n, D))[0]).view(np.uint16)).view(torch.bfloat16)
        for c in (dense, paged):
            tc.insert_prefill(c, r, kv, kv.flip(1))
    steps = torch.from_numpy(rng.normal(size=(150, B, H, 1, D)).astype(np.float32))
    for s in steps.to(torch.bfloat16):
        for c in (dense, paged):
            tc.append_token(c, s, -s)
    assert torch.equal(dense.n_comp, paged.n_comp) and int(paged.n_comp.max()) > PAGE
    for n_bucket in (None, 256):
        view, ref_view = tc.gather_paged(paged, n_bucket), tc.slice_compressed(dense, n_bucket)
        for r in range(B):
            n = int(dense.n_comp[r])
            for a, b in ((view.k, ref_view.k), (view.v, ref_view.v)):
                assert torch.equal(a.chan_perm, b.chan_perm)
                assert torch.equal(a.scale[r, :, :n], b.scale[r, :, :n])
                assert torch.equal(a.zero[r, :, :n], b.zero[r, :, :n])
                for ta, tb in zip(a.tiers, b.tiers):
                    w, P0 = ta.width, n // ta.pack_size
                    assert torch.equal(ta.payload[r, ..., : n * w // 32],
                                       tb.payload[r, ..., : n * w // 32])
                    assert torch.equal(ta.mins[r, ..., :P0], tb.mins[r, ..., :P0])
                    assert torch.equal(ta.shifts[r, ..., : P0 // 4],
                                       tb.shifts[r, ..., : P0 // 4])
        assert torch.equal(view.resid_k, ref_view.resid_k)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    from repro.configs import get_arch as j_get_arch
    from repro.models import get_model as j_get_model
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_numpy

    cfg = j_get_arch("llama2-7b", smoke=True)
    jparams = j_get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch("llama2-7b", smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


def _serve(engine, reqs, record=None):
    from repro_torch.serving import SlotServer

    srv = SlotServer(engine)
    for r in reqs:
        srv.submit(r)
    if record is not None:  # host counter mirror vs device, at retirement
        retire = srv._retire_slot

        def checked(i):
            c = srv.cache[0]
            record.append((srv._counters(srv.slots[i]),
                           (int(c.n_comp[i]), int(c.n_resid[i]))))
            return retire(i)

        srv._retire_slot = checked
    srv.run()
    return srv


def _mixed(cls, vocab):
    r = np.random.default_rng(3)
    spec = ((300, 40), (90, 10), (200, 30), (130, 220), (60, 20))
    return [cls(rid=i, tokens=r.integers(0, vocab, n), max_new=m)
            for i, (n, m) in enumerate(spec)]


@pytest.mark.parametrize("backend", ["fused", "ref"])
def test_paged_serving_equals_dense(smoke, backend):
    """The same traffic through dense and paged storage (chunked admission,
    pages of 256, so K5 tiles as K2 does): the same schedule and
    token-identical outputs; conserved refcounts at every admit/retire;
    every retired row's counters equal the host mirror. (The pool is not
    oversubscribed here: a block would seat requests in other slots and
    steps, and CPU GEMMs may round a row differently by its position in
    the batch. Blocking is held against the reference below.)"""
    from repro_torch.serving import Engine, EngineConfig, Request

    _, _, tcfg, tparams = smoke
    kw = dict(capacity=512, max_batch=3, backend=backend, device="cpu",
              page_size=256)
    dense = Engine(tcfg, tparams, tc.PackKVConfig(), EngineConfig(**kw))
    paged = Engine(tcfg, tparams, dense.pack_cfg,
                   EngineConfig(paged=True, calibrate=False,
                                debug_invariants=True, **kw))
    d = _serve(dense, _mixed(Request, tcfg.vocab))
    mirror = []
    p = _serve(paged, _mixed(Request, tcfg.vocab), mirror)
    for rid, req in d.done.items():
        np.testing.assert_array_equal(req.output, p.done[rid].output, err_msg=rid)
    assert (p.stats.decode_steps, p.stats.slot_reuses) == \
        (d.stats.decode_steps, d.stats.slot_reuses)
    assert p.stats.prefill_chunks == d.stats.prefill_chunks > 0
    assert p.stats.pages_reserved_peak == 5 and p.stats.admission_blocks == 0
    assert len(mirror) == 5 and all(a == b for a, b in mirror), mirror
    for layer in p.cache:  # every page is back on the stack
        assert int(layer.pages.n_free) == 6 and not layer.pages.ref.any()


def _ref_engine(cfg, params, pack=None, **kw):
    """The reference engine with every dispatch compiled by EXACT."""
    from repro.serving import Engine as JEngine
    from repro.serving import EngineConfig as JEngineConfig
    from torch_port_helpers import EXACT

    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngine, "_lane_jit", lane_jit)
        return JEngine(cfg, params, pack or jc.PackKVConfig(),
                       JEngineConfig(backend="xla", **kw))


def test_oversubscribed_scheduler_matches_reference(smoke):
    """An oversubscribed pool (5 pages of 128 for 3 slots of 512) under
    mixed traffic: the port's SlotServer seats the requests in the
    reference's order and slots, with the same admission blocks,
    reservation peak, prefill chunks and decode steps."""
    from repro.serving import Request as JRequest
    from repro.serving import SlotServer as JSlotServer
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg, jparams, tcfg, tparams = smoke
    kw = dict(capacity=512, max_batch=3, decode_chunk=4, paged=True,
              page_size=128, pool_pages=5, calib_tokens=128, bucketed=False)
    spec = ((200, 8), (200, 60), (100, 30), (100, 10), (200, 40), (100, 5))
    mk = lambda cls: [cls(rid=i, tokens=np.random.default_rng(i).integers(0, 512, n),
                          max_new=m) for i, (n, m) in enumerate(spec)]
    runs = {}
    for name, srv, reqs in (
            ("ref", JSlotServer(_ref_engine(cfg, jparams, **kw)), mk(JRequest)),
            ("port", SlotServer(Engine(tcfg, tparams, tc.PackKVConfig(),
                                       EngineConfig(device="cpu", **kw))),
             mk(Request))):
        seated, activate = [], srv._activate
        srv._activate = lambda req, i, tok, a=activate, s=seated: (
            s.append((req.rid, i)), a(req, i, tok))[1]
        for r in reqs:
            srv.submit(r)
        srv.run()
        st = srv.stats
        runs[name] = (seated, st.admission_blocks, st.pages_reserved_peak,
                      st.prefill_chunks, st.decode_steps, st.completed)
    assert runs["port"] == runs["ref"]
    assert runs["port"][1] > 0 and runs["port"][2] <= 5


def test_paged_submit_rejections_match_reference(smoke):
    from repro.serving import Request as JRequest
    from repro.serving import SlotServer as JSlotServer
    from repro_torch.serving import Engine, EngineConfig, Request, SlotServer

    cfg, jparams, tcfg, tparams = smoke
    kw = dict(capacity=512, max_batch=2, paged=True, page_size=128,
              pool_pages=2, calibrate=False)
    port = SlotServer(Engine(tcfg, tparams, tc.PackKVConfig(),
                             EngineConfig(device="cpu", **kw)))
    ref = JSlotServer(_ref_engine(cfg, jparams, **kw))
    cases = (("pages", 400, 100),  # 4 pages > the pool's 2
             ("capacity", 400, 300),  # 700 > capacity + residual
             ("block-aligned", 576, 1),  # 576 block-aligned > capacity
             ("max_new", 10, 0))
    for match, n, max_new in cases:
        for srv, cls in ((port, Request), (ref, JRequest)):
            with pytest.raises(ValueError, match=match):
                srv.submit(cls(rid=9, tokens=np.zeros(n, np.int64), max_new=max_new))
    port.submit(Request(rid=1, tokens=np.zeros(200, np.int64), max_new=50))
    assert len(port.queue) == 1
    # a watermark holds pages back from admission
    held = SlotServer(Engine(tcfg, tparams, tc.PackKVConfig(),
                             EngineConfig(device="cpu", page_watermark=1, **kw)))
    with pytest.raises(ValueError, match="at most 1"):
        held.submit(Request(rid=2, tokens=np.zeros(200, np.int64), max_new=50))
    with pytest.raises(ValueError, match="page_size"):
        Engine(tcfg, tparams, tc.PackKVConfig(),
               EngineConfig(device="cpu", capacity=500, paged=True, page_size=128))


def _dense_pair(smoke, **kw):
    """A dense port engine and the reference's, residual 64 (a row then
    flushes past capacity within a few dozen steps)."""
    from repro_torch.serving import Engine, EngineConfig

    cfg, jparams, tcfg, tparams = smoke
    return (Engine(tcfg, tparams, tc.PackKVConfig(residual=64),
                   EngineConfig(device="cpu", capacity=256, calibrate=False, **kw)),
            _ref_engine(cfg, jparams, pack=jc.PackKVConfig(residual=64),
                        capacity=256, calibrate=False, **kw))


@pytest.mark.parametrize("chunk", [0, 1])
def test_dense_submit_admission_matches_reference(smoke, chunk):
    """Dense engines make the reference's admission decisions, monolithic
    (``chunk`` 0) and chunked. A request past capacity + residual is
    admitted and served by both: the same tokens until the first near-tie,
    and at retirement the row's counters equal the reference's and the
    host mirror's, which does not cap a dense row (its flushes past
    capacity overwrite the last block). A prompt whose whole blocks
    exceed capacity raises in both at the same step (the port in
    ``prefill_cache``)."""
    from repro.serving import Request as JRequest
    from repro.serving import SlotServer as JSlotServer
    from repro_torch.serving import Request, SlotServer

    port_engine, ref_engine = _dense_pair(smoke, max_batch=2, page_size=128,
                                          prefill_chunk_pages=chunk)
    toks = np.random.default_rng(0).integers(0, 512, 300)
    runs = {}
    for name, srv, cls in (("port", SlotServer(port_engine), Request),
                           ("ref", JSlotServer(ref_engine), JRequest)):
        seen, retire = [], srv._retire_slot
        cache = (lambda s=srv: s.cache[0]) if name == "port" else (
            lambda s=srv: jax.tree_util.tree_map(lambda a: a[0], s.cache))

        def record(i, *a, srv=srv, seen=seen, retire=retire, cache=cache):
            c = cache()
            mirror = srv._counters(srv.slots[i])
            seen.append(((int(c.n_comp[i]), int(c.n_resid[i])), mirror))
            return retire(i, *a)

        srv._retire_slot = record
        srv.submit(cls(rid=0, tokens=toks, max_new=100))  # 400 > 256 + 64
        done = {r.rid: np.asarray(r.output) for r in srv.run()}
        runs[name] = (done[0], seen)
    (out, seen), (ref_out, ref_seen) = runs["port"], runs["ref"]
    assert len(out) == len(ref_out) == 100
    assert seen == ref_seen and seen[0][0] == seen[0][1] == (384, 15)
    _, n = steps_before_tie(port_engine, toks, 100)
    assert n >= 8, n
    np.testing.assert_array_equal(out[:n], ref_out[:n])

    steps = {}  # 320 block-aligned prompt tokens > 256
    for name, srv, cls in (("port", SlotServer(port_engine), Request),
                           ("ref", JSlotServer(ref_engine), JRequest)):
        srv.submit(cls(rid=1, tokens=np.concatenate([toks, toks[:20]]), max_new=4))
        for i in range(8):
            try:
                srv.step()
            except (TypeError, ValueError) as e:  # ref: in dynamic_update_slice
                steps[name] = (i, type(e).__name__)
                break
    assert steps["port"][0] == steps["ref"][0], steps
    assert steps["port"][1] == "ValueError"


def test_dense_over_capacity_decode_matches_reference(smoke):
    """Teacher-forced decode of a dense row that flushes past capacity
    (prompt 300 at capacity 256: 256 compressed tokens; the flush at step
    21 overwrites the last block): logits within LOGIT_ATOL of the
    reference's at every step, before and after the clamped writes, and
    equal greedy tokens wherever the reference's margin is clear."""
    te, je = _dense_pair(smoke, max_batch=1)
    toks = np.random.default_rng(1).integers(0, 512, (1, 300))
    jl, jcache = je.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = te.prefill({"tokens": toks})
    for step in range(48):
        want, got = np.asarray(jl)[0], tl.numpy()[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        if margin(want) >= LOGIT_ATOL:
            assert got.argmax() == want.argmax(), step
        tok = np.asarray([[want.argmax()]], np.int32)  # both follow the reference
        jl, jcache = je.decode(jcache, jnp.asarray(tok))
        tl, tcache = te.decode(tcache, tok)
    assert tcache[0].n_comp.tolist() == [320]  # one flush past capacity
    assert np.asarray(jcache.n_comp).ravel().tolist() == [320] * len(tcache)


def test_release_with_duplicates_and_sentinels_matches_reference():
    """``_pool_release_ids`` with a shared page released twice in one call,
    an over-release (clamped), sentinels, and pops after it: the ledger
    byte-exact with the reference's at every step."""
    jpool = jc.alloc_page_pool(batch=3, capacity=4 * 64, page_size=64, pool_pages=9)
    tpool = tc.alloc_page_pool(3, 4 * 64, 64, 9, device="cpu")
    ops_seq = [
        ("pop_rows", [True, False, True], [0, 0, 0]),
        ("pop_prefix", 1, 3),
        ("acquire", [4, 4, 9, 0]),
        ("release", [4, 4, 9, 4, 0, 0, 0, 2]),  # 4 thrice, 0 thrice (held once)
        ("pop_rows", [True, True, True], [1, 3, 2]),
        ("release_row", 1, 2),
        ("pop_all", 1),
    ]
    for op, *a in ops_seq:
        if op == "pop_rows":
            jpool = jc.pool_pop_rows(jpool, jnp.asarray(a[0]), jnp.asarray(a[1]))
            tc.pool_pop_rows(tpool, torch.tensor(a[0]), torch.tensor(a[1]))
        elif op == "pop_prefix":
            jpool, _ = jc.pool_pop_prefix(jpool, a[0], a[1])
            tc.pool_pop_prefix(tpool, a[0], a[1])
        elif op == "pop_all":
            jpool, _ = jc.pool_pop_all_rows(jpool, a[0])
            tc.pool_pop_all_rows(tpool, a[0])
        elif op == "acquire":
            jpool = jc.pool_acquire_ids(jpool, jnp.asarray(a[0], jnp.int32))
            tc.pool_acquire_ids(tpool, torch.tensor(a[0]))
        elif op == "release":
            jpool = jc._pool_release_ids(jpool, jnp.asarray(a[0], jnp.int32))
            tc._pool_release_ids(tpool, torch.tensor(a[0]))
        else:
            jpool = jc.pool_release_row(jpool, a[0], jnp.int32(a[1]))
            tc.pool_release_row(tpool, a[0], a[1])
        for key in ("page_table", "free", "n_free", "ref"):
            np.testing.assert_array_equal(getattr(tpool, key).numpy(),
                                          np.asarray(getattr(jpool, key)),
                                          err_msg=f"{op}: {key}")
        _conserved(tpool)
