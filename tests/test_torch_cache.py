"""The torch port's dense cache manager against the JAX reference: from
identical bf16 K/V, prefill + per-row appends (ragged counters, several
flushes, one past capacity) + slot recycling leave every leaf byte-exact.

The reference runs compiled without excess precision (``jit_exact``);
its compiled zero-points may differ from the op-by-op ones by one fused
FMA, which ``assert_cache_equal`` bounds (``fma_c``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro.data import synthetic_kv
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import cache as tc
from torch_port_helpers import assert_cache_equal, jit_exact
from torch_threads import one_torch_thread  # noqa: F401

B, H, D, CAP = 3, 2, 32, 256
PROMPTS = (150, 90, 40)  # ragged rows: n_resid 22 / 26 / 40 after prefill
N_APPEND = 240  # row 0 flushes 3x, the last one at n_comp == capacity


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _fma_c(cfg):
    return ((cfg.k_quant().max_q + 1) // 2, (cfg.v_quant().max_q + 1) // 2)


def _configs(policy):
    """(reference config, port config) with the same fields."""
    jcfg = jc.PackKVConfig(policy=policy)
    if policy == "packkv":
        rng = np.random.default_rng(7)
        k = _bf16(synthetic_kv(rng, 1, H, 128, D))
        jcfg = jc.calibrate_specs(jnp.asarray(k), jnp.asarray(k), jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tc.PackKVConfig)}
    for name in ("k_spec_static", "v_spec_static"):
        s = fields[name]
        if s is not None:
            fields[name] = tc.TierSpec(s.widths, s.counts, s.pack_size)
    return jcfg, tc.PackKVConfig(**fields)


@pytest.mark.parametrize("policy", ["none", "kivi", "packkv"])
def test_cache_byte_exact(policy):
    jcfg, tcfg = _configs(policy)
    rng = np.random.default_rng(11)
    prompts = [_bf16(synthetic_kv(rng, 1, H, n, D))[0] for n in PROMPTS]
    steps = _bf16(rng.normal(size=(N_APPEND, B, H, 1, D)) * 2.0)
    new_row = _bf16(synthetic_kv(rng, 1, H, 70, D))[0]

    insert = jit_exact(jc.insert_prefill)
    append = jit_exact(jc.append_token)
    reset = jit_exact(jc.reset_slot)
    mask = jit_exact(jc.mask_free_slots)
    T = lambda a: tensor_from_numpy(a, "cpu")

    jcache = jc.alloc_layer_cache(jcfg, B, H, D, CAP)
    tcache = tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu")
    for r, kv in enumerate(prompts):
        jcache = insert(jcache, r, jnp.asarray(kv), jnp.asarray(kv[::-1]))
        tc.insert_prefill(tcache, r, T(kv), T(np.ascontiguousarray(kv[::-1])))
    assert_cache_equal(tcache, jcache, _fma_c(jcfg))
    for i in range(N_APPEND):
        if i == 60:  # a free row rides along and is re-zeroed
            active = np.array([True, True, False])
            jcache = mask(jcache, jnp.asarray(active))
            tc.mask_free_slots(tcache, torch.from_numpy(active))
        if i == 120:  # recycle slot 1 with a new request
            jcache = reset(jcache, 1)
            tc.reset_slot(tcache, 1)
            jcache = insert(jcache, 1, jnp.asarray(new_row), jnp.asarray(new_row))
            tc.insert_prefill(tcache, 1, T(new_row), T(new_row))
        k, v = steps[i], steps[(i * 7) % N_APPEND]
        jcache = append(jcache, jnp.asarray(k), jnp.asarray(v))
        tc.append_token(tcache, T(k), T(v))
        if i in (110, 200):
            assert_cache_equal(tcache, jcache, _fma_c(jcfg))
    assert_cache_equal(tcache, jcache, _fma_c(jcfg))
    counters = list(zip(tcache.n_comp.tolist(), tcache.n_resid.tolist()))
    assert counters[0][0] > CAP  # row 0 flushed past capacity (clamped write)
    assert len(set(counters)) == B  # ragged rows


def test_buckets_equal():
    for cap in (64, 256, 1024, 2048, 4096):
        for unit in (64, 256):
            assert tc.bucket_set(cap, unit) == jc.bucket_set(cap, unit)
            for n in range(0, cap + 65, 37):
                assert tc.bucket_length(n, cap, unit) == jc.bucket_length(n, cap, unit)


def test_slice_compressed_is_a_view():
    """Bucket slices read the capacity buffers in place (no copy)."""
    cfg = tc.PackKVConfig()
    cache = tc.alloc_layer_cache(cfg, 2, 2, 32, 512, device="cpu")
    s = tc.slice_compressed(cache, 256)
    assert s.k.capacity == 256
    for full, part in zip(cache.k.tiers, s.k.tiers):
        assert part.payload.data_ptr() == full.payload.data_ptr()
        assert part.payload.shape[-1] == full.payload.shape[-1] // 2
    assert tc.slice_compressed(cache, None) is cache
    with pytest.raises(ValueError):
        tc.slice_compressed(cache, 48)


def test_prefill_cache_batch_equals_rows():
    """A whole-batch prefill == per-row insert_prefill (per-row calibration)."""
    jcfg, tcfg = _configs("packkv")
    rng = np.random.default_rng(3)
    k = _bf16(synthetic_kv(rng, B, H, 130, D))
    v = _bf16(synthetic_kv(rng, B, H, 130, D))
    T = lambda a: tensor_from_numpy(a, "cpu")
    whole = tc.prefill_cache(tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu"),
                             T(k), T(v))
    rows = tc.alloc_layer_cache(tcfg, B, H, D, CAP, device="cpu")
    for r in range(B):
        tc.insert_prefill(rows, r, T(k[r]), T(v[r]))
    from repro_torch.convert import layer_cache_to_numpy
    from torch_port_helpers import _flat

    a, b = dict(_flat(layer_cache_to_numpy(whole))), dict(_flat(layer_cache_to_numpy(rows)))
    for name in a:
        if a[name] is not None:
            np.testing.assert_array_equal(a[name].view(np.uint8), b[name].view(np.uint8),
                                          err_msg=name)


def test_row_primitives_equal():
    """select_rows / row_update_tokens (clamped starts) against the reference."""
    rng = np.random.default_rng(9)
    new, old = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    mask = np.array([True, False, True])
    np.testing.assert_array_equal(
        tc.select_rows(torch.from_numpy(mask), torch.from_numpy(new),
                       torch.from_numpy(old)).numpy(),
        np.asarray(jc.select_rows(jnp.asarray(mask), jnp.asarray(new), jnp.asarray(old))))
    buf = rng.normal(size=(3, 2, 8, 4)).astype(np.float32)
    x = rng.normal(size=(3, 2, 2, 4)).astype(np.float32)
    starts = np.array([0, 5, 7], np.int32)  # 7 + 2 > 8: clamped to 6
    want = jc.row_update_tokens(jnp.asarray(buf), jnp.asarray(x), jnp.asarray(starts))
    got = tc.row_update_tokens(torch.from_numpy(buf.copy()), torch.from_numpy(x),
                               torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
