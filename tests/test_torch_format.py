"""The torch port's compute-tier format against the JAX reference: every
integer and layout artifact byte-exact from identical inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import tiered as jt
from repro.core.repacking import median_repack_jnp
from repro.data import synthetic_kv
from repro.utils import bits_required_jnp, cdiv as j_cdiv, round_up as j_round_up
from repro_torch import utils as tu
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tcache
from repro_torch.core import tiered as tt
from repro_torch.core.policy import get_policy
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.repacking import median_repack
from torch_port_helpers import assert_zero_fma_close, jit_exact

torch.set_num_threads(2)

WIDTHS = [1, 2, 4, 8, 16]


def J(fn, *static):
    """The reference compiled (integer math: compiling changes no value)."""
    return jax.jit(fn, static_argnums=static)


def T(a):
    return tensor_from_numpy(a, "cpu")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_bits_required_exhaustive():
    r = np.arange(1 << 16, dtype=np.int32)
    want = np.asarray(bits_required_jnp(jnp.asarray(r)))
    np.testing.assert_array_equal(tu.bits_required(torch.from_numpy(r)).numpy(), want)


def test_cdiv_round_up():
    for a in range(0, 70):
        for b in (1, 3, 8, 64):
            assert tu.cdiv(a, b) == j_cdiv(a, b)
            assert tu.round_up(a, b) == j_round_up(a, b)


def test_configs_match_reference():
    from repro.configs import get_arch as j_get_arch

    assert set(ARCHS) == set(SMOKES) == {"llama2-7b", "smollm-135m", "minicpm-2b",
                                         "minitron-4b", "qwen3-32b", "qwen2-moe-a2.7b",
                                         "moonshot-v1-16b-a3b", "internvl2-2b",
                                         "hubert-xlarge", "rwkv6-1.6b",
                                         "recurrentgemma-9b"}
    for name in ARCHS:
        for smoke in (False, True):
            a = dataclasses.asdict(get_arch(name, smoke=smoke))
            b = dataclasses.asdict(j_get_arch(name, smoke=smoke))
            assert a == b
    assert get_arch("llama2-7b").hd == 128


def test_quant_config_and_policies():
    from repro.core.policy import get_policy as j_get_policy

    for rel in (0.02, 0.1, 0.2, 0.3):
        from repro.core.quantization import QuantConfig as JQ

        assert QuantConfig(rel_scale=rel).max_q == JQ(rel_scale=rel).max_q
    for name in ("none", "kivi", "packkv", "packkv_tight", "packkv_aggressive"):
        a = dataclasses.asdict(get_policy(name))
        b = {k: v for k, v in dataclasses.asdict(j_get_policy(name)).items()
             if k in a}
        assert a == b, name


@pytest.mark.parametrize("rel", [0.1, 0.2, 0.02])
def test_quant_tokenwise_bf16_exact(rel):
    """q, scale and zero byte-exact against the reference run op by op
    (``hi - lo`` a bf16 subtraction, then f32)."""
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(synthetic_kv(rng, 2, 3, 96, 32), jnp.bfloat16))
    qc = jcache.PackKVConfig(k_rel_scale=rel).k_quant()
    want = [np.asarray(a) for a in jcache._quant_tokenwise(jnp.asarray(x), qc)]
    got = tcache._quant_tokenwise(T(x), QuantConfig(rel_scale=rel))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_median_repack_exact():
    """Even-length medians average the two middle values; ties stable."""
    rng = np.random.default_rng(2)
    qv = rng.integers(-3, 4, size=(2, 3, 64, 32)).astype(np.int32)
    want = np.asarray(jax.jit(median_repack_jnp)(jnp.asarray(qv)))
    np.testing.assert_array_equal(median_repack(torch.from_numpy(qv)).numpy(), want)
    # the case that separates the two medians: [3,1,2,9] -> 2.5, not 2
    two = np.array([[3, 1, 2, 9], [2, 2, 2, 2]], np.int32)
    np.testing.assert_array_equal(median_repack(torch.from_numpy(two)).numpy(), [1, 0])


@pytest.mark.parametrize("width", [0] + WIDTHS)
def test_pack_unpack_words(width):
    rng = np.random.default_rng(width)
    L = 64
    vals = rng.integers(0, 1 << width if width else 1, size=(3, 5, L)).astype(np.int32)
    want = np.asarray(J(jt.pack_words, 1)(jnp.asarray(vals), width))
    got = tt.pack_words(torch.from_numpy(vals), width)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(
        tt.unpack_words(got, width, L).numpy(),
        np.asarray(J(jt.unpack_words, 1, 2)(jnp.asarray(want), width, L)))


@pytest.mark.parametrize("P", [4, 7, 16])
def test_shift_fields(P):
    rng = np.random.default_rng(P)
    s = rng.integers(0, 4, size=(2, 3, P)).astype(np.int32)
    want = np.asarray(jax.jit(jt.pack_shift_fields)(jnp.asarray(s)))
    got = tt.pack_shift_fields(torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tt.unpack_shift_fields(got, P).numpy(),
                                  np.asarray(J(jt.unpack_shift_fields, 1)(jnp.asarray(want), P)))


@pytest.mark.parametrize("pack", [8, 16])
@pytest.mark.parametrize("width", [0] + WIDTHS)
def test_pack_tier_exact(width, pack):
    """Payload, saturated mins, shift bytes and the mid-rise unpack,
    including values that overflow the tier and mins outside int8."""
    rng = np.random.default_rng(10 * width + pack)
    q = rng.integers(-300, 300, size=(2, 3, 5, 128)).astype(np.int32)
    q[..., :pack] = rng.integers(140, 150, size=q[..., :pack].shape)  # min > 127
    jb = J(jt.pack_tier, 1, 2)(jnp.asarray(q), width, pack)
    tb = tt.pack_tier(torch.from_numpy(q), width, pack)
    np.testing.assert_array_equal(u32(tb.payload), np.asarray(jb.payload))
    np.testing.assert_array_equal(tb.mins.numpy(), np.asarray(jb.mins))
    np.testing.assert_array_equal(tb.shifts.numpy(), np.asarray(jb.shifts))
    np.testing.assert_array_equal(tt.unpack_tier(tb, 128).numpy(),
                                  np.asarray(J(jt.unpack_tier, 1)(jb, 128)))


def _calib_data(seed=3, B=2, H=2, L=192, D=32):
    rng = np.random.default_rng(seed)
    k = np.asarray(jnp.asarray(synthetic_kv(rng, B, H, L, D), jnp.bfloat16))
    v = np.asarray(jnp.asarray(synthetic_kv(rng, B, H, L, D), jnp.bfloat16))
    return k, v


def test_channel_tiers_and_specs_exact():
    """required widths, tier assignment, chosen specs, inverse perms."""
    rng = np.random.default_rng(4)
    q = rng.integers(-60, 60, size=(2, 3, 32, 64)).astype(np.int32)
    q[:, :, :8] //= 16  # narrow channels
    w_j = np.asarray(jax.jit(jt.required_channel_widths)(jnp.asarray(q)))
    w_t = tt.required_channel_widths(torch.from_numpy(q))
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    spec = jt.TierSpec.for_head_dim(32)
    np.testing.assert_array_equal(
        tt.assign_channel_tiers(w_t, tt.TierSpec.for_head_dim(32)).numpy(),
        np.asarray(jt.assign_channel_tiers(jnp.asarray(w_j), spec)))
    for slack in (0, 1):
        a = tt.choose_tier_spec(w_t, slack=slack)
        b = jt.choose_tier_spec(w_j, slack=slack)
        assert (a.widths, a.counts, a.pack_size) == (b.widths, b.counts, b.pack_size)
    perm = np.stack([rng.permutation(32) for _ in range(6)]).reshape(2, 3, 32)
    np.testing.assert_array_equal(
        tt.chan_inverse_perm(torch.from_numpy(perm.astype(np.int32))).numpy(),
        np.asarray(jt.chan_inverse_perm(jnp.asarray(perm, jnp.int32))))


def test_calibrate_specs_equal():
    k, v = _calib_data()
    for policy in ("packkv", "kivi"):
        want = jcache.calibrate_specs(jnp.asarray(k), jnp.asarray(v),
                                      jcache.PackKVConfig(policy=policy))
        got = tcache.calibrate_specs(T(k), T(v), tcache.PackKVConfig(policy=policy))
        for a, b in ((got.k_spec_static, want.k_spec_static),
                     (got.v_spec_static, want.v_spec_static)):
            assert (a.widths, a.counts, a.pack_size) == (b.widths, b.counts, b.pack_size)
        kp_w, vp_w = jcache.calibrate_channel_tiers(jnp.asarray(k), jnp.asarray(v), want)
        kp_t, vp_t = tcache.calibrate_channel_tiers(T(k), T(v), got)
        np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_w))
        np.testing.assert_array_equal(vp_t.numpy(), np.asarray(vp_w))


def test_pack_tiered_and_dequantize_exact():
    """compress_block (quantize, repack, tier-pack) on a whole block against
    the reference compiled; then unpack_tiered / dequantize_tiered on the
    same packed cache. The compiled reference fuses ``lo + c * scale`` into
    one FMA, so its zero-points may differ from the op-by-op value that
    the port and test_quant_tokenwise_bf16_exact agree on by that rounding."""
    k, v = _calib_data(seed=5, L=128)
    # calibration from the port (equal to the reference's: the test above)
    tcfg = tcache.calibrate_specs(T(k), T(v), tcache.PackKVConfig())
    kp, vp = tcache.calibrate_channel_tiers(T(k), T(v), tcfg)
    js = lambda sp: jt.TierSpec(sp.widths, sp.counts, sp.pack_size)
    jcfg = jcache.PackKVConfig(k_spec_static=js(tcfg.k_spec_static),
                               v_spec_static=js(tcfg.v_spec_static))
    jk, jv = jit_exact(jcache.compress_block, static_argnums=2)(
        jnp.asarray(k), jnp.asarray(v), jcfg, jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()))
    tk, tv = tcache.compress_block(T(k), T(v), tcfg, kp, vp)
    for j, t in ((jk, tk), (jv, tv)):
        for jb, tb in zip(j.tiers, t.tiers):
            np.testing.assert_array_equal(u32(tb.payload), np.asarray(jb.payload))
            np.testing.assert_array_equal(tb.mins.numpy(), np.asarray(jb.mins))
            np.testing.assert_array_equal(tb.shifts.numpy(), np.asarray(jb.shifts))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        np.testing.assert_array_equal(t.chan_perm.numpy(), np.asarray(j.chan_perm))
        c = ((jcfg.k_quant() if j is jk else jcfg.v_quant()).max_q + 1) // 2
        assert_zero_fma_close(t.zero.numpy(), np.asarray(j.zero), t.scale.numpy(), c)
        # the port's packed bytes through the reference's readers
        jp = jt.TieredCache(
            tiers=tuple(jt.TierBuffer(payload=jnp.asarray(u32(b.payload)),
                                      mins=jnp.asarray(b.mins.numpy()),
                                      shifts=jnp.asarray(b.shifts.numpy()),
                                      width=b.width, pack_size=b.pack_size)
                        for b in t.tiers),
            chan_perm=jnp.asarray(t.chan_perm.numpy()),
            scale=jnp.asarray(t.scale.numpy()), zero=jnp.asarray(t.zero.numpy()),
            spec=j.spec)
        np.testing.assert_array_equal(tt.unpack_tiered(t).numpy(),
                                      np.asarray(jax.jit(jt.unpack_tiered)(jp)))
        np.testing.assert_array_equal(tt.dequantize_tiered(t).numpy(),
                                      np.asarray(jt.dequantize_tiered(jp)))


def test_tierspec_rules():
    spec = tt.TierSpec.for_head_dim(128)
    j = jt.TierSpec.for_head_dim(128)
    assert (spec.widths, spec.counts) == (j.widths, j.counts)
    assert spec.avg_bits_per_value() == j.avg_bits_per_value()
    assert tt.tiered_bits_per_value(spec) == jt.tiered_bits_per_value(j)
    with pytest.raises(ValueError):
        tt.TierSpec(widths=(3,), counts=(32,))
    with pytest.raises(ValueError):
        tt.TierSpec(widths=(8, 4), counts=(16, 16))
