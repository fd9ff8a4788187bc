"""Shared harness of the torch port's MoE serving tests
(tests/test_torch_moe_{serving,spec,sched}.py): port and reference engines
of each serving mode at one calibration, their traffic, a run traced
event by event (admissions, decode steps, verify passes, the routing of
each), and the comparison against the reference under the margin rule and
the routing rule (``diverged``).

The router inputs of the two packages differ by bf16 rounding upstream
of the router, so with random weights a token's top-k set may differ at
a near-tie, and where the expert capacity binds one such flip moves the
capacity positions of every later token of its call. The comparison therefore
stops, per request, at its first routing difference, which must sit
within ROUTE_NOISE of its tie; the port's MoE itself equals the
reference's on identical inputs (tests/test_torch_moe.py)."""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.serving import engine as je
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import cache as tc
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as te
from torch_port_helpers import EXACT, LOGIT_ATOL, margin, spec_tuple

MOE = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
GAP = 1e-6  # the port's own routing: no token this close to a top-k tie
ROUTE_NOISE = 1e-2  # a routing difference from the reference sits this close
PAGE = 128
DECODE_STEP = ttf.decode_step
# unbucketed decode: one decode compile of the reference an engine
KW = dict(capacity=512, max_batch=2, calib_tokens=128, decode_chunk=4, bucketed=False,
          page_size=PAGE, spec_backoff=0)
MODES = {  # mode -> engine config on top of KW
    "mono": dict(prefill_chunk_pages=0),
    "chunked": dict(prefill_chunk_pages=1),
    "paged": dict(prefill_chunk_pages=1, paged=True),
    "spec": dict(prefill_chunk_pages=1, spec_decode=True),
    "prefix": dict(prefill_chunk_pages=1, paged=True, prefix_cache=True),
    "preempt": dict(prefill_chunk_pages=0, preempt=True),
}


@pytest.fixture(scope="module", params=MOE)
def smoke(request):
    cfg = j_get_arch(request.param, smoke=True)
    jparams = jax.jit(j_get_model(cfg).init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = get_arch(request.param, smoke=True)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    calib = te.Engine(tcfg, tparams, tc.PackKVConfig(),
                      te.EngineConfig(device="cpu", **KW))
    jcalib = je.Engine(cfg, jparams, jc.PackKVConfig(),
                       je.EngineConfig(backend="xla", **KW))
    for a, b in ((calib.pack_cfg.k_spec_static, jcalib.pack_cfg.k_spec_static),
                 (calib.pack_cfg.v_spec_static, jcalib.pack_cfg.v_spec_static)):
        assert spec_tuple(a) == spec_tuple(b)  # byte-exact calibration
    return cfg, jparams, tcfg, tparams, calib.pack_cfg


def port_engine(smoke, mode, **over):
    _, _, tcfg, tparams, pack = smoke
    kw = {**KW, **MODES[mode], **over}
    return te.Engine(tcfg, tparams, pack, te.EngineConfig(
        device="cpu", calibrate=False, debug_invariants=kw.get("paged", False), **kw))


_JITS: dict = {}


def _lane_jit(self, fn, *, static=(), donate=()):
    """The reference engine's dispatches compiled by EXACT, one jitted
    function per (function, bound arguments) across the engines of a
    file, so engines of one config and calibration share their compiles
    (a closure of one engine keeps its own)."""
    key = None
    if isinstance(fn, functools.partial):
        key = (fn.func, fn.args, tuple(sorted(fn.keywords.items())))
    elif getattr(fn, "__closure__", True) is None:
        key = (fn,)
    if key is None:
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)
    key += (static, donate)
    if key not in _JITS:
        _JITS[key] = jax.jit(fn, static_argnames=static, donate_argnames=donate,
                             compiler_options=EXACT)
    return _JITS[key]


def engines(smoke, mode):
    """(port, reference) engines of ``mode`` at the calibrated specs."""
    cfg, jparams, _, _, pack = smoke
    kw = {**KW, **MODES[mode]}
    port = port_engine(smoke, mode)
    jspec = lambda s: jc.TierSpec(s.widths, s.counts, s.pack_size)
    jpack = jc.PackKVConfig(k_spec_static=jspec(pack.k_spec_static),
                            v_spec_static=jspec(pack.v_spec_static))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je.Engine, "_lane_jit", _lane_jit)
        ref = je.Engine(cfg, jparams, jpack, je.EngineConfig(
            backend="xla", calibrate=False, **kw))
    return port, ref


def requests(cls, vocab, mode):
    r = np.random.default_rng(7)
    if mode == "preempt":  # two class-1 rows fill the table; a class-0 arrival
        return [cls(rid=0, tokens=r.integers(0, vocab, 140), max_new=30, priority=1),
                cls(rid=1, tokens=r.integers(0, vocab, 100), max_new=30, priority=1),
                cls(rid=2, tokens=r.integers(0, vocab, 60), max_new=5, priority=0)]
    head = (r.integers(0, vocab, PAGE) if mode == "prefix"
            else np.zeros(0, np.int64))
    return [cls(rid=i, tokens=np.concatenate([head, r.integers(0, vocab, n)]), max_new=m)
            for i, (n, m) in enumerate(zip((140, 60, 100) if mode != "prefix"
                                           else (20, 60, 36), (10, 12, 8)))]


class Replay:
    """A drafter replaying a plain run's outputs with every third proposal
    wrong (full, partial and zero acceptance)."""

    def __init__(self, outputs: dict, vocab: int):
        self._ref, self._vocab, self._pos = outputs, vocab, {}

    def seed(self, slot, tokens):
        self._pos[slot] = [self._ref.get(tuple(int(t) for t in tokens[:-1]), []), 1]

    def extend(self, slot, tokens):
        self._pos[slot][1] += len(tuple(tokens))

    def drop(self, slot):
        self._pos.pop(slot, None)

    def draft(self, slot, k):
        stream, cur = self._pos[slot]
        return [(int(t) + 1) % self._vocab if (cur + j) % 3 == 0 else int(t)
                for j, t in enumerate(stream[cur:cur + k])]


class Trace:
    """What a server run showed: every admission's logits in call order;
    for the port, each request's token margins in emission order, the
    routing events (admissions, decode steps, verify passes) and the
    requests a verify pass dropped a routed choice of."""

    def __init__(self):
        self.admits: list = []  # (rid, logits)
        self.margins = collections.defaultdict(list)
        self.verify_dropped: set[int] = set()
        self.pending: dict[int, float] = {}
        self.rows: list = []
        self.seg = None
        self.depth = 0
        self.current = None  # the request a chunked admission is for
        # (first routed call, end, kind, {row of the call's tokens or None
        # for all of them: (rid, token)})
        self.events: list = []
        self.calls: list = []  # routed calls (port: RoutedCall; reference: idx)


_REF_STORE: list | None = None  # where the reference's routing goes


def _log_ref_routing(idx):
    if _REF_STORE is not None:
        _REF_STORE.append(np.asarray(idx))


def ref_routing_logged(mp):
    """Make the reference's routed dispatch report each call's top-k
    indices to ``_REF_STORE`` (an ordered callback: they come in call
    order). Dispatches compiled under it keep reporting there."""
    if getattr(jmoe._dispatch_compute, "logged", False):
        return
    orig = jmoe._dispatch_compute

    def logged(x2, router, wg, wu, wd, E, k, capacity_factor):
        probs = jax.nn.softmax(jnp.dot(x2.astype(jnp.float32), router), axis=-1)
        _, idx = jax.lax.top_k(probs, k)
        jax.debug.callback(_log_ref_routing, idx, ordered=True)
        return orig(x2, router, wg, wu, wd, E, k, capacity_factor)

    logged.logged = True
    mp.setattr(jmoe, "_dispatch_compute", logged)


def run(eng, reqs, mp, drafter=None, preempt=False):
    """Serve ``reqs`` on a fresh server over ``eng`` (port or reference)
    and trace it. Returns (server, trace)."""
    port = isinstance(eng, te.Engine)
    srv = (te.SlotServer if port else je.SlotServer)(eng, drafter=drafter)
    tr = Trace()
    host = lambda x: x.numpy() if port else np.asarray(x)
    rows = lambda: [a.req.rid if a is not None else None for a in srv.slots]
    by_len = {len(r.tokens): r.rid for r in reqs}
    assert len(by_len) == len(reqs)  # prompt lengths name the requests

    def event(fn, kind, rowmap):
        """Run ``fn`` and record its routed calls as one event (a call
        nested in another event, such as the port's chunk_final running
        chunk_step, is part of the outer one)."""
        if tr.depth:
            return fn()
        n0 = len(tr.calls)
        tr.depth += 1
        try:
            out = fn()
        finally:
            tr.depth -= 1
        tr.events.append((n0, len(tr.calls), kind, rowmap))
        return out

    def admit(name, tok_arg):
        fn = getattr(eng, name)

        def wrapped(cache, slot, *a, **kw):
            rid = (tr.current if name == "chunk_final"
                   else by_len[len((cache, slot, *a)[tok_arg])])
            logits, out = event(lambda: fn(cache, slot, *a, **kw), "admit", {None: (rid, 0)})
            tr.admits.append((rid, host(logits)))
            tr.pending[slot] = margin(host(logits))
            return logits, out
        mp.setattr(eng, name, wrapped)

    admit("insert_request", 2)
    admit("chunk_final", 3)
    admit("insert_request_prefix", 2)
    step_fns = {n: getattr(eng, n) for n in ("chunk_init", "chunk_step", "prefix_chunk_start",
                                             "prefix_chunk_step", "prefix_chunk_finish")}

    def chunk_init(prompt_len):
        tr.current = by_len[prompt_len]
        return step_fns["chunk_init"](prompt_len)

    def prefix_start(cache, prompt_len, *a, **kw):
        tr.current = by_len[prompt_len]
        return step_fns["prefix_chunk_start"](cache, prompt_len, *a, **kw)

    def chunk(scratch, tokens, n_ctx):
        return event(lambda: step_fns["chunk_step"](scratch, tokens, n_ctx),
                     "admit", {None: (tr.current, 0)})

    def seg(mini, tokens, n_ctx):
        logits, mini = event(lambda: step_fns["prefix_chunk_step"](mini, tokens, n_ctx),
                             "shared" if n_ctx == 0 else "admit", {None: (tr.current, 0)})
        tr.admits.append((tr.current, host(logits)))
        tr.seg = margin(host(logits))
        return logits, mini

    def fin(cache, slot, *a, **kw):
        tr.pending[slot] = tr.seg
        return step_fns["prefix_chunk_finish"](cache, slot, *a, **kw)

    mp.setattr(eng, "chunk_init", chunk_init)
    mp.setattr(eng, "prefix_chunk_start", prefix_start)
    mp.setattr(eng, "chunk_step", chunk)
    mp.setattr(eng, "prefix_chunk_step", seg)
    mp.setattr(eng, "prefix_chunk_finish", fin)
    chunk_fn, verify_fn = eng.decode_chunk, eng.decode_verify

    def attach():
        tr.rows = rows()
        for slot, rid in enumerate(tr.rows):
            if rid is not None and slot in tr.pending and rid not in tr.margins:
                tr.margins[rid].append(tr.pending.pop(slot))

    def decode_chunk(cache, token, active, n_steps, *a, **kw):
        attach()
        outs = {b: len(srv.slots[b].out) for b, rid in enumerate(tr.rows)
                if rid is not None}
        n0 = len(tr.calls)
        toks, n_exec, cache = chunk_fn(cache, token, active, n_steps, *a, **kw)
        per = (len(tr.calls) - n0) // max(n_exec, 1)
        for s in range(n_exec):  # one event a step, rows by batch index
            tr.events.append((n0 + s * per, n0 + (s + 1) * per, "decode",
                              {b: (tr.rows[b], t + s) for b, t in outs.items()}))
        return toks, n_exec, cache

    def verify(cache, toks, *a, **kw):
        attach()
        w = np.asarray(toks).shape[1]
        outs = {b * w + j: (rid, len(srv.slots[b].out)) for b, rid in enumerate(tr.rows)
                if rid is not None for j in range(w)}
        n0 = len(tr.calls)
        out = event(lambda: verify_fn(cache, toks, *a, **kw), "verify", outs)
        if port:
            for c in tr.calls[n0:]:
                hit = c.dropped.view(len(tr.rows), -1).sum(1).numpy()
                tr.verify_dropped |= {rid for rid, h in zip(tr.rows, hit)
                                      if rid is not None and h}
        return out

    mp.setattr(eng, "decode_chunk", decode_chunk)
    mp.setattr(eng, "decode_verify", verify)
    if port:
        def step(*a, **kw):
            logits, cache = DECODE_STEP(*a, **kw)
            for b, rid in enumerate(tr.rows):
                if rid is not None:
                    tr.margins[rid].append(margin(logits[b].numpy()))
            return logits, cache
        mp.setattr(ttf, "decode_step", step)
    else:
        ref_routing_logged(mp)

    def serve():
        if preempt:
            srv.submit(reqs[0])
            srv.submit(reqs[1])
            for _ in range(3):  # both class-1 rows admitted and decoding
                srv.step()
            srv.submit(reqs[2])  # the table is full: a swap-out
        else:
            for r in reqs:
                srv.submit(r)
        srv.run()

    if port:
        with tmoe.routing_log(keep_tensors=True) as log:
            tr.calls = log
            serve()
        assert len(srv.done) == len(reqs)
        assert log and min(float(c.min_gap) for c in log) > GAP, "a routed near-tie"
    else:
        global _REF_STORE
        _REF_STORE = tr.calls
        try:
            serve()
        finally:
            _REF_STORE = None
    return srv, tr


def first_tie(margins) -> int:
    """The first token whose top-2 logit margin is below LOGIT_ATOL."""
    return next((i for i, x in enumerate(margins) if x < LOGIT_ATOL), len(margins))


def diverged(tp, tr, rids, margins) -> dict:
    """Per request, the first token from which its run may differ from the
    reference's by routing: the two runs' routed calls are compared event
    by event (an admission call, a decode step, a verify pass) while their
    schedules agree.

    The router inputs of the two packages differ by bf16 rounding
    upstream, so a top-k set may differ at a near-tie. The first such difference of a request
    must sit within ROUTE_NOISE of its tie in the port; from there on the
    request is not compared: at its admission (a flipped token moves the
    capacity positions of the later ones, and its K/V), at its row of a
    decode step, at every row of a verify pass (C may bind there), and for
    every request at a flip in a shared prefix page. A step fed a token
    past the request's first logit near-tie (the margin rule) may route
    anything, and is not checked."""
    div: dict = {}
    tie = {rid: first_tie(margins[rid]) for rid in rids}
    for e, (n0, n1, kind, rowmap) in enumerate(tp.events):
        if e >= len(tr.events) or tr.events[e][:3] != (n0, n1, kind) \
                or tr.events[e][3].keys() != rowmap.keys():
            # the schedules part (a speculative run's acceptance follows
            # its tokens): every later event's requests from their token
            for *_, later in tp.events[e:]:
                for rid, tok in later.values():
                    if rid is not None:
                        div.setdefault(rid, tok)
            break
        for c, ridx in zip(tp.calls[n0:n1], tr.calls[n0:n1]):
            r = c.routing
            flip = (np.sort(r.idx.numpy(), axis=1) != np.sort(ridx, axis=1)).any(1)
            for i in np.nonzero(flip)[0]:
                rid, tok = rowmap.get(i, rowmap.get(None, (None, 0)))
                if rid is None or rid in div or tok > tie[rid]:
                    continue
                assert float(r.gap[i]) < ROUTE_NOISE, (
                    f"request {rid}: routing differs at gap {float(r.gap[i])} ({kind} event {e}, T {c.T}, site {c.site}, token {i})")
                if kind == "shared":
                    div.update({x: 0 for x in rids})
                elif kind == "verify":
                    for rid_, tok_ in rowmap.values():
                        div.setdefault(rid_, tok_)
                else:
                    div[rid] = tok
    return div


def against_reference(port, ref, tp, tr, margins=None, rids=None) -> int:
    """Admission logits within LOGIT_ATOL in call order for every request
    whose admission routed as the reference's; tokens equal until the
    port's first margin below LOGIT_ATOL or the request's first routing
    difference at a tie. Returns tokens compared."""
    margins = tp.margins if margins is None else margins
    div = diverged(tp, tr, list(port.done), margins)
    assert len(tp.admits) == len(tr.admits) > 0
    for (rid, a), (rid_b, b) in zip(tp.admits, tr.admits):
        assert rid == rid_b
        if div.get(rid, 1) > 0:
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"request {rid}'s admission")
    margins = tp.margins if margins is None else margins
    compared = 0
    for rid in (port.done if rids is None else rids):
        a, b = np.asarray(port.done[rid].output), np.asarray(ref.done[rid].output)
        m = margins[rid][:len(a)]
        assert len(m) == len(a), (rid, len(m), len(a))
        n = min(first_tie(m), div.get(rid, len(m)))
        np.testing.assert_array_equal(a[:n], b[:n], err_msg=f"request {rid}")
        compared += n
    return compared


def outputs(srv):
    return {rid: np.asarray(r.output) for rid, r in srv.done.items()}


