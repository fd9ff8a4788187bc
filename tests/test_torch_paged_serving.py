"""The torch port's paged serving against its dense serving and against
the JAX reference's engine (paged storage itself is in
tests/test_torch_paged.py).

  * Paged and dense serving give the same tokens in the port, with
    conserved refcounts and the host counter mirror at every retirement;
  * on an oversubscribed pool the port's scheduler admits in the
    reference's order with the same blocks and reservation peak; the
    paged submit rejections raise as the reference's do;
  * dense engines past capacity make the reference's admission decisions
    and decode within LOGIT_ATOL of it.

The reference runs compiled without excess precision
(``torch_port_helpers.EXACT``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import cache as jc
from repro_torch.core import cache as tc
from torch_port_helpers import LOGIT_ATOL, margin, steps_before_tie
from torch_threads import one_torch_thread  # noqa: F401


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
