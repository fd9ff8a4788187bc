"""The port's compressed-cache attention (K2 with K1 inlined) against the JAX
reference: caches built by the reference are carried across with
``convert.layer_cache_from_numpy`` and both sides read the same bytes.

Tolerance rtol=1e-5, atol=1e-4: f32 throughout, summed in another order.
The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_gpu.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.core.tiered import TierSpec as JTierSpec
from repro.data import synthetic_kv
from repro.kernels import ref as jref
from repro.kernels.packed_attention import fused_packed_attention as j_fused
from repro.kernels.unpack import decode_tier_tile as j_decode
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tc
from repro_torch.core import tiered as tt
from repro_torch.kernels import ops, ref
from repro_torch.kernels.packed_attention import (
    fused_packed_attention,
    fused_packed_attention_torch,
)
from repro_torch.kernels.unpack import decode_tier_tile
from torch_port_helpers import ref_cache_to_torch

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-4)
# the reference's oracles, compiled (f32 math: compiling changes no rounding
# these tolerances could see, and running them op by op takes seconds)
j_attention = jax.jit(jref.packed_decode_attention_ref)
j_kscores = jax.jit(jref.kpack_scores_ref)
j_vout = jax.jit(jref.vpack_out_ref)


def _port_cfg(jcfg):
    return tc.PackKVConfig(policy=jcfg.policy, pack_size=jcfg.pack_size)


def _make(rng, B, Hkv, D, L, lengths, *, calibrated=True, spec=None, pack=8):
    """A reference dense cache whose rows hold ``lengths`` tokens (0 = an
    empty row), and its port twin. One whole-batch prefill, then each row's
    counters cut to its length (the tokens past them are masked)."""
    n0 = max(lengths)
    k = jnp.asarray(synthetic_kv(rng, B, Hkv, n0, D))
    v = jnp.asarray(synthetic_kv(rng, B, Hkv, n0, D))
    if spec is None and calibrated:  # the port's calibrate_specs picks the
        # reference's specs (test_torch_format.py), faster than op by op
        tcfg = tc.calibrate_specs(tensor_from_numpy(k, "cpu"),
                                  tensor_from_numpy(v, "cpu"), tc.PackKVConfig())
        spec = (JTierSpec(*_spec(tcfg.k_spec_static)),
                JTierSpec(*_spec(tcfg.v_spec_static)))
    elif spec is not None:
        spec = (spec, spec)
    cfg = jc.PackKVConfig(pack_size=pack, k_spec_static=spec and spec[0],
                          v_spec_static=spec and spec[1])
    cache = jax.jit(jc.prefill_cache)(jc.alloc_layer_cache(cfg, B, Hkv, D, L), k, v)
    n_comp = [min((n // 64) * 64, (n0 // 64) * 64) for n in lengths]
    n_resid = [min(n - c, n0 - (n0 // 64) * 64) for n, c in zip(lengths, n_comp)]
    cache = dataclasses.replace(cache, n_comp=jnp.asarray(n_comp, jnp.int32),
                                n_resid=jnp.asarray(n_resid, jnp.int32))
    return cache, ref_cache_to_torch(cache, _port_cfg(cfg))


def _spec(s):
    return (s.widths, s.counts, s.pack_size)


def _args(c, q, sm):
    return (q, c.k, c.v, c.resid_k, c.resid_v, c.n_comp, c.n_resid, sm)


# (B, Hkv, G, D, L, tile, per-row prompt lengths) — tests/test_kernels.py's
# shapes (G up to 8, D 32..128) with ragged rows, an empty row among them
CASES = [
    (1, 1, 1, 32, 128, 32, (88,)),
    (3, 2, 2, 64, 256, 64, (192, 72, 0)),
    (1, 3, 2, 128, 256, 64, (216,)),
    (2, 1, 8, 64, 512, 256, (472, 300)),
]


@pytest.mark.parametrize("B,Hkv,G,D,L,tile,lengths", CASES)
def test_packed_decode_attention_matches_reference(B, Hkv, G, D, L, tile, lengths):
    """Both backends of ops.packed_decode_attention against the
    reference's ref.packed_decode_attention_ref; the ref oracles too."""
    rng = np.random.default_rng(B * 100 + D)
    jcache, tcache = _make(rng, B, Hkv, D, L, lengths)
    qn = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    sm = 1.0 / np.sqrt(D)
    want = np.asarray(j_attention(*_args(jcache, jnp.asarray(qn), sm)))
    for backend in ("ref", "fused"):
        got = ops.packed_decode_attention(*_args(tcache, torch.from_numpy(qn), sm),
                                          backend=backend, tile_l=tile)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=backend)
    if G > 1:  # the two halves of the oracle on their own (GQA shapes)
        np.testing.assert_allclose(
            ref.kpack_scores_ref(torch.from_numpy(qn), tcache.k, sm).numpy(),
            np.asarray(j_kscores(jnp.asarray(qn), jcache.k, sm)), **TOL)
        w = rng.random(size=(B, Hkv * G, L)).astype(np.float32)
        np.testing.assert_allclose(
            ref.vpack_out_ref(torch.from_numpy(w), tcache.v).numpy(),
            np.asarray(j_vout(jnp.asarray(w), jcache.v)), **TOL)
    for r, n in enumerate(lengths):
        if n == 0:  # an empty row attends to nothing
            assert not got[r].any()


@pytest.mark.parametrize("case", [0, 1, 3])
def test_fused_partials_match_pallas_interpret(case):
    """The plain version's (o, m, l) partials against the reference's
    Pallas kernel in interpret mode."""
    B, Hkv, G, D, L, tile, lengths = CASES[case]
    rng = np.random.default_rng(case)
    jcache, tcache = _make(rng, B, Hkv, D, L, lengths)
    qn = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    want = j_fused(jnp.asarray(qn), jcache.k, jcache.v, jcache.n_comp, 0.125,
                   tile_l=tile, interpret=True)
    got = fused_packed_attention_torch(torch.from_numpy(qn), tcache.k, tcache.v,
                                       tcache.n_comp, 0.125, tile_l=tile)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_pack16_and_uncalibrated_specs():
    """pack_size 16 (tests/test_kernels.py's pack-16 case) and the default
    frac-based spec, whose gaussian data exercises the shift-packs."""
    rng = np.random.default_rng(16)
    spec = JTierSpec(widths=(4, 8), counts=(48, 16), pack_size=16)
    for kw in (dict(spec=spec, pack=16), dict(calibrated=False)):
        jcache, tcache = _make(rng, 2, 2, 64, 256, (192, 130), **kw)
        qn = rng.normal(size=(2, 4, 64)).astype(np.float32)
        want = j_attention(*_args(jcache, jnp.asarray(qn), 0.125))
        got = ops.packed_decode_attention(*_args(tcache, torch.from_numpy(qn), 0.125),
                                          backend="fused", tile_l=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pack", [8, 16])
@pytest.mark.parametrize("width", [1, 2, 4, 8, 16])
def test_decode_tier_tile_exact(width, pack):
    rng = np.random.default_rng(width * pack)
    q = rng.integers(-200, 200, size=(6, 128)).astype(np.int32)
    buf = tt.pack_tier(torch.from_numpy(q), width, pack)
    got = decode_tier_tile(buf.payload, buf.mins, buf.shifts, width, pack)
    want = j_decode(jnp.asarray(buf.payload.numpy().view(np.uint32)),
                    jnp.asarray(buf.mins.numpy()), jnp.asarray(buf.shifts.numpy()),
                    width, pack)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), tt.unpack_tier(buf, 128).numpy())


def test_kernel_rejects_what_the_reference_rejects():
    """Width-0 tiers have no kernel decode; tiles must divide the context
    and be multiples of 4 * pack_size."""
    zero = tc.PackKVConfig(k_spec_static=tt.TierSpec((0, 8), (16, 16)),
                           v_spec_static=tt.TierSpec((0, 8), (16, 16)))
    cache = tc.alloc_layer_cache(zero, 1, 1, 32, 128, device="cpu")
    q = torch.zeros((1, 1, 32))
    cache.n_comp.fill_(64)
    with pytest.raises(ValueError):
        fused_packed_attention(q, cache.k, cache.v, cache.n_comp, 1.0)
    ok = tc.alloc_layer_cache(tc.PackKVConfig(), 1, 1, 32, 96, device="cpu")
    with pytest.raises(ValueError):  # a 64-token tile does not divide 96
        fused_packed_attention(q, ok.k, ok.v, ok.n_comp, 1.0, tile_l=64)
    with pytest.raises(ValueError):
        ops.packed_decode_attention(q, ok.k, ok.v, ok.resid_k, ok.resid_v,
                                    ok.n_comp, ok.n_resid, 1.0, backend="pallas")


def test_launch_counter_counts_only_kernel_launches():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    cache = tc.alloc_layer_cache(tc.PackKVConfig(), 1, 1, 32, 128, device="cpu")
    before = fused_packed_attention.launches
    fused_packed_attention(torch.zeros((1, 1, 32)), cache.k, cache.v,
                           cache.n_comp, 1.0)
    assert fused_packed_attention.launches == before
