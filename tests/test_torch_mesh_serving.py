"""Serving on a (dp, kv) mesh through the port's SlotServer: every token
and every byte of the cache after the run bitwise equal to the (1, 1)
engine's on the same traffic (tests/test_sharded_serving.py's matrix and
traffic).

  * meshes (1, 2), (1, 4), (2, 1) and (2, 2), each over the modes dense,
    paged, prefix cache, speculative decode, policy 'none' and monolithic
    admission (against the (1, 1) engine's chunked admission);
  * preemption (swap out and resume) and the session cache (park and
    resume) at (1, 2) and (2, 2);
  * the qwen3-32b smoke model (GQA, G = 2) at (1, 2), the qwen2-moe-a2.7b
    smoke model at (1, 2) and (2, 2);
  * one scenario against the reference's (1, 1) SlotServer, up to each
    request's first logit near-tie (tests/torch_port_helpers.py).

Every mesh engine runs with ``debug_invariants``: after each admission and
retirement every lane's page ledger and counters are lane (0, 0)'s, and the
dp lanes of one head block hold the same bytes."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.cache import PackKVConfig as JPack
from repro.models import get_model as j_get_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SlotServer as JSlotServer
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.cache import PackKVConfig
from repro_torch.kernels.sharded import MeshCache, join_cache
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig, Request, SlotServer
from repro_torch.utils import tree_flatten
from torch_port_helpers import EXACT, steps_before_tie

torch.set_num_threads(2)

PAGE = 128
MESHES = [(1, 2), (1, 4), (2, 1), (2, 2)]


@pytest.fixture(scope="module")
def llama():
    jcfg = j_get_arch("llama2-7b", smoke=True)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = get_arch("llama2-7b", smoke=True)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _engine(cfg, params, mesh, mode="paged", policy="packkv", **kw):
    return Engine(cfg, params, PackKVConfig(policy=policy), EngineConfig(
        capacity=512, max_batch=2, calib_tokens=128, bucket_unit=64,
        paged=mode != "dense", page_size=PAGE, prefix_cache=mode == "prefix",
        mesh_shape=tuple(mesh), device="cpu", debug_invariants=True, **kw))


def _outputs(srv) -> list:
    """Every request's tokens, then every byte the cache holds after the
    run (a mesh's lanes put back together): with random smoke weights a
    wrong attention output may leave the argmax alone, but it moves the
    K/V the next layer writes."""
    cache = srv.cache if isinstance(srv.cache, list) else join_cache(srv.cache, "cpu")
    return ([list(map(int, srv.done[i].output)) for i in sorted(srv.done)],
            [x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
             for x in tree_flatten(cache)[0]])


def _same(a, b) -> bool:
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a[1], b[1]))


def _drive_plain(cfg, params, mesh, mode, **kw):
    eng = _engine(cfg, params, mesh, mode, **kw)
    srv = SlotServer(eng)
    r = np.random.default_rng(0)
    sys_p = (r.integers(0, cfg.vocab, 2 * PAGE) if mode == "prefix"
             else np.zeros(0, np.int64))
    for rid in range(3):
        srv.submit(Request(rid=rid, max_new=6, tokens=np.concatenate(
            [sys_p, r.integers(0, cfg.vocab, 100 + rid * 30)])))
    srv.run()
    assert (eng.mesh is None) == (tuple(mesh) == (1, 1))
    assert isinstance(srv.cache, MeshCache) == (eng.mesh is not None)
    return _outputs(srv), srv


MODES = {  # mode -> (engine mode, engine options of the mesh run)
    "dense": ("dense", {}),
    "paged": ("paged", {}),
    "prefix": ("prefix", {}),
    "spec": ("paged", {"spec_decode": True}),
    "none": ("paged", {"policy": "none"}),
    "mono": ("paged", {"prefill_chunk_pages": 0}),
}


@pytest.mark.parametrize("name", list(MODES))
def test_mesh_matrix_equals_single_device(llama, name):
    """Each mode at every mesh shape: the same tokens and cache bytes as
    (1, 1); monolithic admission's tokens also equal the (1, 1) engine's
    chunked admission's (its pages are popped at other steps, so only the
    tokens compare)."""
    _, _, cfg, params = llama
    mode, kw = MODES[name]
    want, ref = _drive_plain(cfg, params, (1, 1), mode, **kw)
    if name == "mono":
        chunked, ref = _drive_plain(cfg, params, (1, 1), mode)
        assert want[0] == chunked[0] and ref.stats.prefill_chunks > 0
    for mesh in MESHES:
        got, srv = _drive_plain(cfg, params, mesh, mode, **kw)
        assert _same(got, want), (name, mesh)
        if name == "prefix":
            assert srv.stats.prefix_hits == ref.stats.prefix_hits > 0
        if name == "spec":
            assert srv.stats.spec_launches == ref.stats.spec_launches > 0
        if name == "mono":
            assert srv.stats.prefill_chunks == 0


def _drive_preempt(cfg, params, mesh):
    srv = SlotServer(_engine(cfg, params, mesh, preempt=True, decode_chunk=4,
                             prefill_chunk_pages=1))
    r = np.random.default_rng(11)
    sys_p = r.integers(0, cfg.vocab, 2 * PAGE)
    for rid in range(2):
        srv.submit(Request(rid=rid, max_new=40, priority=1, tokens=np.concatenate(
            [sys_p, r.integers(0, cfg.vocab, 40 + 13 * rid)])))
    for _ in range(8):
        srv.step()
    srv.submit(Request(rid=2, max_new=6, priority=0,
                       tokens=r.integers(0, cfg.vocab, 100)))
    srv.run()
    assert srv.stats.preemptions >= 1, "swap-out path never fired"
    return _outputs(srv)


def _drive_session(cfg, params, mesh):
    srv = SlotServer(_engine(cfg, params, mesh, session_cache=True))
    r = np.random.default_rng(0)
    for rid in range(2):
        srv.submit(Request(rid=rid, max_new=6,
                           tokens=r.integers(0, cfg.vocab, 150 + rid * 40)))
    srv.run()
    outs = [list(map(int, srv.done[i].output)) for i in range(2)]
    for rid in range(2):
        d = srv.done[rid]
        trace = np.concatenate([np.asarray(d.tokens), np.asarray(d.output),
                                r.integers(0, cfg.vocab, 8)])
        srv.submit(Request(rid=10 + rid, max_new=6, tokens=trace))
    srv.run()
    assert srv.stats.session_hits == 2, "returning sessions missed"
    toks, cache = _outputs(srv)
    return outs + toks, cache


@pytest.mark.parametrize("drive", [_drive_preempt, _drive_session],
                         ids=["preempt", "session"])
def test_mesh_swap_and_session_equal_single_device(llama, drive):
    """Swapped-out and parked rows cross the host boundary as full-head
    minis (the lanes' blocks put back together) and come back split by
    head: resumes stay exact."""
    _, _, cfg, params = llama
    want = drive(cfg, params, (1, 1))
    for mesh in ((1, 2), (2, 2)):
        assert _same(drive(cfg, params, mesh), want), mesh


@pytest.mark.parametrize("arch,meshes", [("qwen3-32b", [(1, 2)]),
                                         ("qwen2-moe-a2.7b", [(1, 2), (2, 2)])])
def test_gqa_and_moe_on_a_mesh(arch, meshes):
    """GQA (two KV heads, G = 2: a lane's query heads are its KV heads'
    groups) and MoE (the routed MLP on the controller) serve dense and
    paged on a mesh with the (1, 1) tokens."""
    cfg = get_arch(arch, smoke=True)
    params = get_model(cfg).init(torch.Generator().manual_seed(1), cfg)
    for mode in ("dense", "paged"):
        want, _ = _drive_plain(cfg, params, (1, 1), mode)
        for mesh in meshes:
            got, _ = _drive_plain(cfg, params, mesh, mode)
            assert _same(got, want), (arch, mode, mesh)


def test_mesh_against_reference_engine(llama):
    """Dense serving at (2, 2) against the reference's (1, 1) SlotServer on
    the same traffic: each request's tokens agree up to the port's first
    near-tie of its B=1 run, and the mesh's tokens equal that B=1 run."""
    jcfg, jparams, cfg, params = llama

    def lane_jit(self, fn, *, static=(), donate=()):
        return jax.jit(fn, static_argnames=static, donate_argnames=donate,
                       compiler_options=EXACT)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEngine, "_lane_jit", lane_jit)
        je = JEngine(jcfg, jparams, JPack(policy="packkv"), JEngineConfig(
            capacity=256, max_batch=2, prefill_chunk_pages=0, backend="xla"))
    te = Engine(cfg, params, PackKVConfig(), EngineConfig(
        capacity=256, max_batch=2, prefill_chunk_pages=0, device="cpu",
        mesh_shape=(2, 2)))
    single = Engine(cfg, params, PackKVConfig(), EngineConfig(
        capacity=256, max_batch=2, prefill_chunk_pages=0, device="cpu"))
    lens, max_new = (127, 90, 191), (40, 30, 35)
    mk = lambda cls: [cls(rid=i, tokens=np.random.default_rng(5 + i).integers(0, 512, n),
                          max_new=m) for i, (n, m) in enumerate(zip(lens, max_new))]
    srv, jsrv = SlotServer(te), JSlotServer(je)
    for a, b in zip(mk(Request), mk(JRequest)):
        srv.submit(a)
        jsrv.submit(b)
    done = {r.rid: np.asarray(r.output) for r in srv.run()}
    ref = {r.rid: np.asarray(r.output) for r in jsrv.run()}
    compared = 0
    for req in mk(Request):
        b1, n = steps_before_tie(single, req.tokens, req.max_new)
        assert b1 == list(done[req.rid][:n])
        np.testing.assert_array_equal(done[req.rid][:n], ref[req.rid][:n])
        compared += n
    assert compared >= 20, compared
