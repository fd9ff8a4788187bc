"""The serving mesh of the torch port against the reference: the sharding
rule, the lane, lane caches and the refusals.

  * the port's ``serving_cache_specs`` equals ``repro``'s leaf for leaf
    (the reference's leading layer dim dropped) on the dense, paged and
    prefix-admission caches of the llama2-7b and qwen3-32b smoke models
    (qwen3's two KV heads do not divide four lanes: the fallback), on
    duck-typed meshes of {dp: 2, kv: 2} and {dp: 1, kv: 4};
  * ``Lane.split`` / ``merge`` / ``owned_rows`` equal the reference's
    under ``jax.vmap`` over named axes (its ``axis_index`` and ``psum``);
    split then merge gives the input back bitwise;
  * a mesh engine's prefill leaves in each lane that head block of the
    (1, 1) cache, byte for byte, and of the reference's ``prefill_cache``
    of the same K/V (its zero-points within the compiled reference's FMA,
    as tests/test_torch_configs.py holds them); ``split_cache`` then
    ``join_cache`` is the identity;
  * the refusals keep the reference's wording; --mesh on the CLI.

The serving matrix (mesh tokens == (1, 1) tokens) is
tests/test_torch_mesh_serving.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import cache as jc
from repro.distributed import sharding as jsh
from repro.kernels.sharded import Lane as JLane
from repro.models import get_model as j_get_model
from repro_torch.configs import get_arch
from repro_torch.convert import layer_cache_to_numpy
from repro_torch.core import cache as tc
from repro_torch.distributed.sharding import serving_cache_specs
from repro_torch.kernels.sharded import (
    Mesh,
    join_cache,
    lane_lists,
    split_cache,
)
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig
from repro_torch.utils import tree_flatten
from torch_port_helpers import _flat, assert_zero_fma_close, jit_exact, ref_cache_arrays

torch.set_num_threads(2)


class FakeMesh:
    """Duck-typed mesh (as tests/test_distributed.py builds one)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"dp": 2, "kv": 2}), FakeMesh({"dp": 1, "kv": 4})]


def _ref_names(path) -> tuple:
    return tuple(str(p.idx) if hasattr(p, "idx") else str(getattr(p, "name", getattr(p, "key", p)))
                 for p in path)


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-32b"])
@pytest.mark.parametrize("kind", ["dense", "paged", "prefix_mini"])
def test_serving_rule_matches_reference(arch, kind):
    cfg, jcfg = get_arch(arch, smoke=True), j_get_arch(arch, smoke=True)
    paged = kind == "paged"
    jpack = jc.PackKVConfig(paged=paged, page_size=128, pool_pages=8)
    tpack = tc.PackKVConfig(paged=paged, page_size=128, pool_pages=8)
    batch, cap = (1, 128) if kind == "prefix_mini" else (2, 512)
    jcache = j_get_model(jcfg).alloc_cache(jcfg, jpack, batch, cap)
    tcache = get_model(cfg).alloc_cache(cfg, tpack, batch, cap, "cpu")
    for mesh in MESHES:
        want = {_ref_names(path): tuple(spec)[1:] for path, spec in
                jax.tree_util.tree_flatten_with_path(
                    jsh.serving_cache_specs(jcache, mesh),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        got = serving_cache_specs(tcache[0], mesh)
        assert got == want, (kind, mesh.shape)
        if kind != "paged":  # a dense leaf splits its dim 1 or nothing
            assert {s.index("kv") for s in got.values() if "kv" in s} <= {1}
        split = [s for s in got.values() if "kv" in s]
        assert bool(split) == (cfg.n_kv_heads % mesh.shape["kv"] == 0)


def _vmapped(fn, axes: dict):
    """fn() under jax.vmap over the named axes dp (outer) and kv: an array
    [n_dp, n_kv, ...] of every lane's result."""
    inner = jax.vmap(lambda _: fn(), axis_name="kv")
    return jax.vmap(lambda _: inner(jnp.arange(axes["kv"])), axis_name="dp")(
        jnp.arange(axes["dp"]))


@pytest.mark.parametrize("n_dp,n_kv", [(1, 2), (1, 4), (2, 1), (2, 2)])
def test_lane_split_merge_owned_rows_match_reference(n_dp, n_kv):
    x = np.random.default_rng(n_dp * 10 + n_kv).normal(size=(4, 8, 3)).astype(np.float32)
    mesh = Mesh(n_dp, n_kv, ("cpu",) * (n_dp * n_kv))
    lanes = mesh.lanes
    jl = JLane(n_kv=n_kv, n_dp=n_dp)
    axes = {"dp": n_dp, "kv": n_kv}
    # split: lane (d, j)'s block == the reference's at axis index (d, j)
    want = np.asarray(_vmapped(lambda: jl.split(jnp.asarray(x), 1), axes))
    blocks = [lane.split(torch.from_numpy(x), 1) for lane in lanes]
    for lane, b in zip(lanes, blocks):
        np.testing.assert_array_equal(b.numpy(), want[lane.dp, lane.kv])
    # owned rows: the reference's mask, or None where it returns None
    for n_rows in (4, 3):
        if n_dp == 1 or n_rows % n_dp:  # the reference returns None
            assert all(lane.owned_rows(n_rows) is None for lane in lanes)
            continue
        masks = np.asarray(_vmapped(lambda: jl.owned_rows(n_rows), axes))
        for lane in lanes:
            np.testing.assert_array_equal(lane.owned_rows(n_rows).numpy(),
                                          masks[lane.dp, lane.kv])
    # merge: each lane computes f(its block) on its rows; the reference's
    # psum of disjoint scatters and the port's concatenation agree bitwise
    own = lanes[0].owned_rows(4)
    f = lambda b: b * 3.0 - 1.0
    want = np.asarray(_vmapped(lambda: jl.merge(
        f(jl.split(jnp.asarray(x), 1)), 1, 8, jl.owned_rows(4)), axes))[0, 0]
    got = lanes[0].merge([f(b) for b in blocks], 1, rows=own is not None)
    np.testing.assert_array_equal(got.numpy(), want)
    back = lanes[0].merge(blocks, 1)
    assert torch.equal(back, torch.from_numpy(x))


# -- lane caches --------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    from repro_torch.convert import params_from_numpy

    jcfg = j_get_arch("llama2-7b", smoke=True)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = get_arch("llama2-7b", smoke=True)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, params


def _equal_bytes(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _copy_cache(cache):
    from repro_torch.utils import tree_map

    return tree_map(lambda x: x.clone(), cache)


def _head_block(arrays: dict, lane) -> dict:
    """A dense reference cache's numpy leaves cut to ``lane``'s head
    block (dim 1 of every leaf but the counters)."""
    out = {}
    for name, a in arrays.items():
        if a is None or name in ("n_comp", "n_resid"):
            out[name] = a
        else:
            loc = a.shape[1] // lane.n_kv
            out[name] = a[:, lane.kv * loc:(lane.kv + 1) * loc]
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_lane_caches_are_head_blocks_of_single_device(llama, paged):
    jcfg, cfg, params = llama
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 200))
    ecfg = dict(capacity=256, max_batch=2, calib_tokens=128, device="cpu",
                paged=paged, page_size=128)
    single = Engine(cfg, params, tc.PackKVConfig(), EngineConfig(**ecfg))
    _, one = single.prefill({"tokens": toks})
    slot = single.alloc_slot_cache()
    _, slot = single.insert_request(slot, 1, toks[0])
    for shape in ((1, 2), (2, 2), (1, 4)):
        eng = Engine(cfg, params, tc.PackKVConfig(),
                     EngineConfig(**ecfg, mesh_shape=shape))
        assert eng.pack_cfg == single.pack_cfg
        _, mc = eng.prefill({"tokens": toks})
        assert mc.lanes[-1][0].resid_k.shape[1] == cfg.n_kv_heads // shape[1]
        want = split_cache(one, eng.mesh)
        assert all(_equal_bytes(a, b) for la, lb in zip(mc.lanes, want.lanes)
                   for a, b in zip(la, lb)), shape
        assert all(_equal_bytes(a, b) for a, b in zip(join_cache(mc, "cpu"), one))
        # the slot table after an insert (paged: pages popped in every lane)
        ms = eng.alloc_slot_cache()
        _, ms = eng.insert_request(ms, 1, toks[0])
        want = split_cache(slot, eng.mesh)
        assert all(_equal_bytes(a, b) for la, lb in zip(ms.lanes, want.lanes)
                   for a, b in zip(la, lb)), shape
        assert all(_equal_bytes(a, b) for a, b in zip(join_cache(ms, "cpu"), slot))
        # swap the row out and back: the mesh's minis are the (1, 1) minis
        n_pages = 2 if paged else 0
        _, mini = single.evacuate(_copy_cache(slot), 1, n_pages)
        ms, mmini = eng.evacuate(ms, 1, n_pages)
        assert all(_equal_bytes(a, b) for a, b in zip(mmini, mini)), shape
        ms = eng.restore(ms, 1, mmini, (), n_pages)
        want = split_cache(slot, eng.mesh)
        assert all(_equal_bytes(a, b) for la, lb in zip(ms.lanes, want.lanes)
                   for a, b in zip(la, lb)), shape

    # across packages: each lane's prefill == that head block of the
    # reference's prefill_cache of the port's K/V
    if paged:
        return
    _, raw = get_model(cfg).prefill(params, cfg, tc.PackKVConfig(policy="none"),
                                    256, {"tokens": torch.from_numpy(toks)})
    jpack = jc.PackKVConfig(k_spec_static=_jspec(single.pack_cfg.k_spec_static),
                            v_spec_static=_jspec(single.pack_cfg.v_spec_static))
    compress = jit_exact(jax.vmap(lambda k, v: jc.prefill_cache(
        jc.alloc_layer_cache(jpack, 1, jcfg.n_kv_heads, jcfg.hd, 256), k, v)))
    # the prompt's K/V: 192 tokens in the raw region, 8 in the residual
    kv = [jnp.asarray(np.stack([torch.cat([getattr(r, "raw_" + a)[..., :192, :],
                                           getattr(r, "resid_" + a)[..., :8, :]], -2)
                                .to(torch.float32).numpy() for r in raw]), jnp.bfloat16)
          for a in ("k", "v")]
    ref = jax.tree_util.tree_map(np.asarray, compress(*kv))
    fma = ((jpack.k_quant().max_q + 1) // 2, (jpack.v_quant().max_q + 1) // 2)
    for lane, layers in lane_lists(mc):
        for i, layer in enumerate(layers):
            want = _head_block(dict(_flat(ref_cache_arrays(
                jax.tree_util.tree_map(lambda a: a[i], ref)))), lane)
            got = dict(_flat(layer_cache_to_numpy(layer)))
            assert got.keys() == want.keys()
            for name, w in want.items():
                g = got[name]
                if w is None:
                    assert g is None, name
                elif name in ("k.zero", "v.zero"):
                    assert_zero_fma_close(g, w, got[name[0] + ".scale"],
                                          fma[name[0] == "v"])
                else:
                    assert g.dtype == w.dtype and g.shape == w.shape, name
                    np.testing.assert_array_equal(g, w, err_msg=name)


def _jspec(spec):
    from repro.core.tiered import TierSpec

    return TierSpec(spec.widths, spec.counts, spec.pack_size)


# -- refusals and the CLI ---------------------------------------------------

def _ecfg(mesh_shape, **kw):
    return EngineConfig(capacity=512, max_batch=2, calib_tokens=128,
                        bucket_unit=64, paged=True, page_size=128,
                        mesh_shape=mesh_shape, device="cpu", **kw)


def test_mesh_off_is_plain_engine(llama):
    _, cfg, params = llama
    eng = Engine(cfg, params, tc.PackKVConfig(), _ecfg((1, 1)))
    assert eng.mesh is None
    assert isinstance(eng.alloc_slot_cache(), list)


def test_mesh_refusals_keep_reference_wording(llama):
    _, cfg, params = llama  # n_kv_heads = 4
    for arch in ("rwkv6-1.6b", "recurrentgemma-9b"):
        with pytest.raises(ValueError, match="--mesh"):
            Engine(get_arch(arch, smoke=True), params, tc.PackKVConfig(policy="none"),
                   EngineConfig(capacity=512, max_batch=2, calib_tokens=128,
                                mesh_shape=(1, 2), device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        Engine(cfg, params, tc.PackKVConfig(), _ecfg((1, 3)))
    with pytest.raises(ValueError, match="positive"):
        Engine(cfg, params, tc.PackKVConfig(), _ecfg((0, 2)))
    # a cuda engine asking for more cards than the host has
    with pytest.raises(ValueError, match="devices.*mesh_devices"):
        Engine(cfg, params, tc.PackKVConfig(),
               EngineConfig(capacity=512, max_batch=2, mesh_shape=(64, 4), device="cuda"))
    with pytest.raises(ValueError, match="devices"):
        Engine(cfg, params, tc.PackKVConfig(), _ecfg((1, 2), mesh_devices=("cpu",)))


def test_serve_cli_mesh(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                       "--mesh", "1,2", "--requests", "3", "--max-new", "4",
                       "--prompt-len", "96", "--batch", "2", "--capacity", "256"]) == 0
    out = capsys.readouterr().out
    assert "serving mesh dp=1 x kv=2" in out and "3 requests" in out
    with pytest.raises(SystemExit, match=r"--mesh takes 'dp,kv' \(e.g. 1,2\), got 'x'"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "x"])
