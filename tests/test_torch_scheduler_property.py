"""The scheduler property harness of tests/test_scheduler_property.py run
over the port's ``SlotServer``.

The reference file drives its ``SlotServer`` over a host-only stub engine
and checks, after every scheduler step, FIFO (per-class) admission,
reservation and page conservation, bounded stall, speculation counts,
preemption and swap-store drainage, fault storms and the session store's
balance against a pure-Python oracle (``_drive``). Here the same oracle,
its code unchanged, drives the port's ``SlotServer`` (``te.SlotServer``,
``te.EngineConfig``, ``te.Request``) over the stub with its logits as
tensors (``_TorchStub``), every ledger op replayed on independent copies
and asserted equal (the reference's replicated-ledger check), and the
fault plans built from the port's ``FaultPlan``.

The seeded cases of the reference (invariants, priority preemption, fault
and session storms, aging, the straggler watchdog) run as they are, the
hypothesis case with a small example count. Of
``test_scheduler_ledger_device_count_independent`` only the replica check
runs: the port has no mesh, and comparing whole runs' event logs depends
on the straggler watchdog's wall-clock readings."""
import copy
import os
import types

import numpy as np
import pytest
import torch

import test_scheduler_property as tsp
from repro_torch.distributed import FaultEvent, FaultPlan, StragglerMonitor
from repro_torch.serving import engine as te
from test_scheduler_property import CASES, PREEMPT_CASES, _StubEngine
from torch_threads import one_torch_thread  # noqa: F401


class _TorchStub(_StubEngine):
    """The reference's host-only stub engine, its logits as tensors."""

    def insert_request(self, cache, slot, tokens):
        logits, cache = super().insert_request(cache, slot, tokens)
        return torch.from_numpy(logits), cache

    def chunk_step(self, scratch, tokens, n_ctx):
        logits, scratch = super().chunk_step(scratch, tokens, n_ctx)
        return torch.from_numpy(logits), scratch

    def decode(self, cache, tok, n_bucket=None):
        logits, cache = super().decode(cache, tok, n_bucket)
        return torch.from_numpy(logits), cache


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


class _ReplicaStub(_TorchStub):
    """``_TorchStub`` whose ledger ops each run once per replica on
    independent deep copies of their inputs, the results asserted equal:
    an op that read state the scheduler does not hold would diverge them
    (the reference's ``_MeshStubEngine`` check, ``n_dev`` replicas)."""

    def __init__(self, ecfg, pool_pages, mesh_shape=(1, 1)):
        super().__init__(ecfg, pool_pages)
        self.n_dev = mesh_shape[0] * mesh_shape[1]

    def __getattribute__(self, name):
        if name in tsp._MeshStubEngine._REPLAYED:
            base = getattr(_TorchStub, name)

            def replayed(*args, **kw):
                mark = len(self.log)
                first = base(self, *copy.deepcopy(args), **copy.deepcopy(kw))
                for _ in range(self.n_dev - 1):
                    del self.log[mark:]  # replicas log once
                    rep = base(self, *copy.deepcopy(args), **copy.deepcopy(kw))
                    assert _same(first, rep), f"ledger replica diverged in {name}"
                return first

            return replayed
        return super().__getattribute__(name)


def _engine_config(*, mesh_shape=(1, 1), **kw):
    del mesh_shape  # the port serves one device
    return te.EngineConfig(device="cpu", **kw)


# the reference's oracle, its names bound to the port's scheduler
_drive = types.FunctionType(
    tsp._drive.__code__,
    {**tsp.__dict__, "EngineConfig": _engine_config, "SlotServer": te.SlotServer,
     "Request": te.Request, "_MeshStubEngine": _ReplicaStub},
    "_drive", tsp._drive.__defaults__, tsp._drive.__closure__)
_drive.__kwdefaults__ = tsp._drive.__kwdefaults__


@pytest.mark.parametrize("paged,chunk_pages,spec", CASES)
def test_scheduler_invariants_seeded(paged, chunk_pages, spec):
    n_verify = 0
    for seed in range(25):
        n_verify += _drive(np.random.default_rng(seed), paged=paged,
                           chunk_pages=chunk_pages, spec=spec).spec_launches
    if spec:  # the sweep must reach the verify path
        assert n_verify > 0


@pytest.mark.parametrize("paged,chunk_pages", PREEMPT_CASES)
def test_scheduler_priority_preempt_seeded(paged, chunk_pages):
    preempts = 0
    for seed in range(25):
        preempts += _drive(np.random.default_rng(seed), paged=paged,
                           chunk_pages=chunk_pages, prio=True,
                           preempt=True).preemptions
    assert preempts > 0, "sweep never exercised the swap-out path"


@pytest.mark.parametrize("paged,chunk_pages", [(True, 1), (True, 0), (False, 1)])
def test_scheduler_ledger_replicas_agree(paged, chunk_pages):
    """Speculation, priorities, preemption and session parks all on, every
    ledger op replayed on four independent copies: the replicas agree."""
    for seed in range(8):
        _drive(np.random.default_rng(seed), paged=paged, chunk_pages=chunk_pages,
               spec=True, prio=True, preempt=True, session=True, mesh_shape=(2, 2))


def _squeeze_plan():
    return FaultPlan([FaultEvent(step=2, kind="pool_squeeze", arg=10**6),
                      FaultEvent(step=9, kind="pool_squeeze", arg=0)])


FAULT_CASES = [
    ("cancel_storm", lambda: FaultPlan.storm("cancel", start=3, count=4, every=2)),
    ("deadline_storm",
     lambda: FaultPlan.storm("deadline", start=4, count=3, every=3, arg=2)),
    ("pool_squeeze", _squeeze_plan),
    ("chunk_abort", lambda: FaultPlan.storm("chunk_abort", start=2, count=5, every=2)),
    ("mixed",
     lambda: FaultPlan.storm("cancel", start=3, count=3, every=4) + _squeeze_plan()
     + FaultPlan.storm("chunk_abort", start=5, count=3, every=3)),
]


@pytest.mark.parametrize("name,factory", FAULT_CASES, ids=[c[0] for c in FAULT_CASES])
def test_scheduler_fault_storms(name, factory):
    died = 0
    for seed in range(15):
        for paged, chunk_pages in ((True, 1), (True, 2), (False, 1), (True, 0)):
            stats = _drive(np.random.default_rng(seed), paged=paged,
                           chunk_pages=chunk_pages, prio=True, preempt=True,
                           fault_factory=factory)
            died += stats.cancelled + stats.expired
    if name in ("cancel_storm", "deadline_storm", "mixed"):
        assert died > 0, "storm never killed a request"


SESSION_CASES = [
    ("park_storm", lambda: FaultPlan.storm("park", start=2, count=5, every=2)),
    ("park_resume",
     lambda: FaultPlan.storm("park", start=2, count=4, every=3)
     + FaultPlan.storm("resume", start=4, count=4, every=3)),
    ("resume_pressure",
     lambda: FaultPlan.storm("park", start=2, count=3, every=2)
     + FaultPlan.storm("resume", start=5, count=3, every=2)
     + FaultPlan([FaultEvent(step=6, kind="pool_squeeze", arg=10**6),
                  FaultEvent(step=12, kind="pool_squeeze", arg=0)])),
    ("expiry_race",
     lambda: FaultPlan.storm("park", start=2, count=4, every=2)
     + FaultPlan.storm("session_expire", start=5, count=4, every=2)
     + FaultPlan.storm("resume", start=5, count=4, every=2)),
]


@pytest.mark.parametrize("name,factory", SESSION_CASES, ids=[c[0] for c in SESSION_CASES])
def test_scheduler_session_storms(name, factory):
    parks = hits = 0
    for seed in range(15):
        for paged, chunk_pages, preempt in ((True, 1, True), (True, 2, False),
                                            (False, 1, True), (True, 0, False)):
            stats = _drive(np.random.default_rng(seed), paged=paged,
                           chunk_pages=chunk_pages, prio=True, preempt=preempt,
                           session=True, fault_factory=factory)
            parks += stats.session_parks
            hits += stats.session_hits
    assert parks > 0, "storm never parked a session"
    if name == "park_resume":
        assert hits > 0, "resume storm never produced a session hit"


def test_straggler_watchdog_degrades_spec():
    ecfg = _engine_config(capacity=256, max_batch=2, paged=True, page_size=64,
                          pool_pages=8, calibrate=False, prefill_chunk_pages=1,
                          decode_chunk=1, spec_decode=True, spec_k=2)
    eng = _TorchStub(ecfg, 8)
    plan = FaultPlan.storm("straggler", start=8, count=3, every=1, arg=1e3)
    srv = te.SlotServer(eng, fault_plan=plan, straggler=StragglerMonitor(patience=1))
    for rid in range(3):
        srv.submit(te.Request(rid=rid, max_new=40, tokens=np.full((65,), rid, np.int64)))
    srv.run()
    assert srv._spec_degraded, "watchdog never excluded the straggler"
    assert srv.stats.degraded_steps > 0
    assert len(srv.done) == 3
    for r in srv.done.values():
        assert r.status == "done" and len(r.output) == r.max_new


def _flood(aging: int):
    """One-slot server, an endless class-0 flood, one class-2 request."""
    ecfg = _engine_config(capacity=128, max_batch=1, paged=False, calibrate=False,
                          prefill_chunk_pages=0, decode_chunk=1, aging_steps=aging)
    srv = te.SlotServer(_TorchStub(ecfg, 4))
    srv.submit(te.Request(rid=0, max_new=2, tokens=np.full((3,), 0, np.int64)))
    low = te.Request(rid=999, max_new=2, tokens=np.full((3,), 96, np.int64), priority=2)
    srv.submit(low)
    for rid in range(1, 41):
        srv.submit(te.Request(rid=rid, max_new=2, tokens=np.full((3,), rid % 97, np.int64)))
        srv.step()
    return low


def test_priority_aging_no_starvation():
    assert _flood(aging=2).status == "done"


def test_strict_priority_starves_without_aging():
    assert _flood(aging=0).status == "queued"


def test_scheduler_invariants_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=int(os.environ.get("HYPOTHESIS_MAX_EXAMPLES", "30")),
                  deadline=None, suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(seed=st.integers(0, 2**31 - 1), paged=st.booleans(),
               chunk_pages=st.integers(0, 3), spec=st.booleans(), prio=st.booleans(),
               preempt=st.booleans(), session=st.booleans())
    def prop(seed, paged, chunk_pages, spec, prio, preempt, session):
        _drive(np.random.default_rng(seed), paged=paged, chunk_pages=chunk_pages,
               spec=spec, prio=prio, preempt=preempt, session=session)

    prop()
