"""The torch port's storage tier and synthetic data against the JAX
package's host modules, on the CPU, from identical numpy inputs.

Byte-exact: bit widths, pack minima, payload words and bits, total bits,
repack permutations (all five modes, coarse rel scales included, where
greedy seeds tie and only numpy's summation order decides), stream
entries and directories, KIVI's integers, the synthetic data. Float
outputs are exact where the reference computes in float64 (the stream's
``decode_block``); the jnp dequantizers may fuse ``q * scale + zero``
into one FMA, so the port's results are held within half an ulp of the
product plus half an ulp of each result (``assert_zero_fma_close``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as rb
from repro.core import block_format as rbf
from repro.core import kivi as rk
from repro.core import quantization as rq
from repro.core import repacking as rr
from repro.data import ShardedTokenStream as RStream
from repro.data import synthetic_kv as r_synthetic_kv
from repro.data import zipf_token_batch as r_zipf
from repro_torch import convert
from repro_torch.core import bitpack as tb
from repro_torch.core import block_format as tbf
from repro_torch.core import kivi as tk
from repro_torch.core import quantization as tq
from repro_torch.core import repacking as tr
from repro_torch.data import ShardedTokenStream, synthetic_kv, zipf_token_batch
from torch_port_helpers import assert_zero_fma_close, jit_exact

torch.set_num_threads(2)

# the llama2-7b-like profile of the storage-tier benchmarks (V: token
# categories, half the channel outliers)
K_PROFILE = dict(channel_scale=2.0, smooth=0.88, noise=0.20, outlier_frac=0.05,
                 spike_frac=0.10, spike_mag=4.0)
V_PROFILE = dict(K_PROFILE, n_patterns=4, pattern_scale=1.2, outlier_frac=0.025)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def assert_block_equal(got: tb.PackedBlock, want: rb.PackedBlock):
    np.testing.assert_array_equal(u32(got.payload), want.payload)
    assert got.widths.dtype == torch.uint8 and got.mins.dtype == torch.int32
    np.testing.assert_array_equal(got.widths.numpy(), want.widths)
    np.testing.assert_array_equal(got.mins.numpy(), want.mins)
    assert (got.pack_size, tuple(got.shape), got.payload_bits) == (
        want.pack_size, tuple(want.shape), want.payload_bits)
    assert got.total_bits() == want.total_bits()


def kv_blocks(seed: int, n_blocks: int, d: int):
    """K- and V-like float32 blocks [n_blocks, 64, d] (synthetic_kv)."""
    rng = np.random.default_rng(seed)
    k = r_synthetic_kv(rng, 1, n_blocks, 64, d, **K_PROFILE)[0]
    v = r_synthetic_kv(rng, 1, n_blocks, 64, d, **V_PROFILE)[0]
    return k, v


# ---------------------------------------------------------------------------
# bit-packing
# ---------------------------------------------------------------------------


def test_storage_bits_required_exact():
    """numpy's exact bit length, not the compute tier's XLA log2: 14 bits
    at 8192 and 16 at 32768."""
    r = np.concatenate([np.arange(1 << 16), [2 ** 20 - 1, 2 ** 20, 2 ** 31 - 1,
                                             2 ** 31, 2 ** 40 + 3]]).astype(np.int64)
    got = tb.bits_required(torch.from_numpy(r))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), rb.bits_required(r))
    assert tb.bits_required(torch.tensor([8192, 32768])).tolist() == [14, 16]


@pytest.mark.parametrize("pack", [4, 8, 16])
def test_pack_block_matches_reference(pack):
    """Every width 0-16 (a block per width, values shifted off zero), an
    all-constant block and a mixed one: words, widths, minima, payload
    bits, total bits and the round trip, one block at a time and batched."""
    rng = np.random.default_rng(pack)
    blocks = [rng.integers(-3, -3 + (1 << w), size=(64, 24)) for w in range(17)]
    blocks.append(np.full((64, 24), 7))
    mixed = rng.integers(0, 2, size=(64, 24)) << rng.integers(0, 16, size=(1, 24))
    blocks.append(mixed)
    for q in blocks:
        got = tb.pack_block(torch.from_numpy(q), pack)
        want = rb.pack_block(q, pack)
        assert_block_equal(got, want)
        np.testing.assert_array_equal(tb.unpack_block(got).numpy(), q)
    assert tb.pack_block(torch.from_numpy(blocks[-2]), pack).payload.numel() == 0
    batch = np.stack(blocks).reshape(-1, 1, 64, 24)  # leading dims [19, 1]
    packed = tb.pack_block(torch.from_numpy(batch), pack)
    assert isinstance(packed, tb.PackedBlocks)
    np.testing.assert_array_equal(tb.unpack_block(packed).numpy(), batch)
    np.testing.assert_array_equal(packed.total_bits().reshape(-1).numpy(),
                                  [rb.pack_block(q, pack).total_bits() for q in blocks])
    for got, q in zip(packed.blocks(), blocks):
        assert_block_equal(got, rb.pack_block(q, pack))


def test_packed_sizes_match_reference():
    rng = np.random.default_rng(3)
    sm = rb.SizeModel(width_field_bits=5, min_field_bits=16, token_meta_bits=64)
    tsm = tb.SizeModel(width_field_bits=5, min_field_bits=16, token_meta_bits=64)
    for q in (rng.integers(0, 11, size=(64, 32)), rng.integers(0, 256, size=(32, 48)),
              np.full((16, 8), 3)):
        t = torch.from_numpy(q)
        for pack in (4, 8, 16):
            for axis in (0, 1):
                if q.shape[axis] % pack:
                    continue
                assert tb.packed_payload_bits(t, pack, axis) == \
                    rb.packed_payload_bits(q, pack, axis)
                for kw in ({}, {"n_token_meta": 0}, {"n_token_meta": 5}):
                    assert tb.packed_total_bits(t, pack, axis, **kw) == \
                        rb.packed_total_bits(q, pack, axis, **kw)
                    assert tb.packed_total_bits(t, pack, axis, tsm, **kw) == \
                        rb.packed_total_bits(q, pack, axis, sm, **kw)
                    assert tb.compression_ratio(t, pack, axis, **kw) == \
                        rb.compression_ratio(q, pack, axis, **kw)


def test_packed_block_convert_round_trip():
    q = np.random.default_rng(4).integers(0, 40, size=(64, 16))
    want = rb.pack_block(q, 8)
    got = convert.packed_block_from_numpy(want, "cpu")
    assert_block_equal(got, want)
    back = convert.packed_block_to_numpy(tb.pack_block(torch.from_numpy(q), 8))
    assert back["payload"].dtype == np.uint32
    for f in dataclasses.fields(rb.PackedBlock):
        np.testing.assert_array_equal(back[f.name], getattr(want, f.name))
    assert (rb.unpack_block(rb.PackedBlock(**back)) == q).all()


# ---------------------------------------------------------------------------
# quantization and KIVI
# ---------------------------------------------------------------------------


def assert_quantizer_matches(quant, r_quant, deq, r_deq, x: np.ndarray, group=None):
    """A port quantizer / dequantizer pair against the reference's jnp one.
    Run op by op (the written math): q, scale, zero and the dequantized
    values byte-exact. Compiled (``jit_exact``): q and zero byte-exact;
    scale within one f32 ulp (XLA turns a division by ``max_q`` into a
    product with its reciprocal); the dequantized values within the FMA
    bound (``assert_zero_fma_close``). ``group``: the channel-wise group
    length (scale per (group, channel))."""
    got = [a.numpy() for a in quant(torch.from_numpy(x))]
    eager = [np.asarray(a) for a in r_quant(jnp.asarray(x))]
    compiled = [np.asarray(a) for a in jit_exact(r_quant)(jnp.asarray(x))]
    for g, e, c in zip(got, eager, compiled):
        assert g.dtype == e.dtype == c.dtype and g.shape == e.shape == c.shape
        np.testing.assert_array_equal(g, e)
    q, s, z = got
    np.testing.assert_array_equal(q, compiled[0])
    np.testing.assert_array_equal(z, compiled[2])
    assert (np.abs(s - compiled[1]) <= np.spacing(s)).all()
    d = deq(*[torch.from_numpy(a) for a in got]).numpy()
    np.testing.assert_array_equal(d, np.asarray(r_deq(*[jnp.asarray(a) for a in eager])))
    d_c = np.asarray(jit_exact(r_deq)(*[jnp.asarray(a) for a in got]))
    if group is not None:
        q = q.reshape(*q.shape[:-2], -1, group, q.shape[-1])
        d, d_c = d.reshape(q.shape), d_c.reshape(q.shape)
    assert_zero_fma_close(d, d_c, s, q.astype(np.float32))


@pytest.mark.parametrize("cfg", [
    rq.QuantConfig(rel_scale=0.1), rq.QuantConfig(bits=2),
    rq.QuantConfig(rel_scale=0.2, granularity="channel", group_size=32),
    rq.QuantConfig(bits=3, granularity="channel")], ids=str)
def test_quantizers_match_jnp(cfg):
    """``quantize`` / ``dequantize`` as ``assert_quantizer_matches`` holds
    them, a constant unit included; ``max_relative_error`` within one f32
    ulp of the reference's and at most 0.5."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 3, 128, 64)) * rng.uniform(0.1, 10, size=(1, 3, 1, 64))
         ).astype(np.float32)
    x[0, 0, :64] = 1.5  # constant tokens and channel groups
    tcfg = tq.QuantConfig(**dataclasses.asdict(cfg))
    assert_quantizer_matches(
        lambda a: tq.quantize(a, tcfg), lambda a: rq.quantize(a, cfg),
        lambda *a: tq.dequantize(*a, tcfg), lambda *a: rq.dequantize(*a, cfg), x,
        cfg.group_size if cfg.granularity == "channel" else None)
    err = tq.max_relative_error(torch.from_numpy(x), tcfg)
    assert abs(err - rq.max_relative_error(jnp.asarray(x), cfg)) <= 2 ** -23
    assert err <= 0.5 * (1 + 2 ** -20)


def test_kivi_matches_reference():
    """The analytic ratios (6.4 / 4.57 at 2 / 3 bits, 64-group) equal the
    reference's over a grid of rel scales; the quantizers as
    ``assert_quantizer_matches`` holds them."""
    assert abs(tk.kivi_cr(2, 64) - 6.4) < 0.01 and abs(tk.kivi_cr(3, 64) - 4.57) < 0.01
    for bits in (2, 3, 4, 8):
        for g in (32, 64, 128):
            assert tk.kivi_cr(bits, g) == rk.kivi_cr(bits, g)
    for rel in np.concatenate([np.geomspace(1e-3, 1.0, 60), [0.05, 0.1, 0.2, 1 / 3,
                                                             1 / 7, 1 / 15, 0.5]]):
        for g in (32, 64):
            assert tk.kivi_cr_from_rel_scale(float(rel), g) == \
                rk.kivi_cr_from_rel_scale(float(rel), g), rel
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 128, 64)).astype(np.float32)
    for kb, vb in ((2, 2), (3, 4)):
        cfg, tcfg = rk.KIVIConfig(k_bits=kb, v_bits=vb), tk.KIVIConfig(k_bits=kb, v_bits=vb)
        assert_quantizer_matches(
            lambda a: tk.compress_k(a, tcfg), lambda a: rk.compress_k(a, cfg),
            lambda *a: tk.decompress_k(*a, tcfg), lambda *a: rk.decompress_k(*a, cfg),
            x, cfg.group_size)
        assert_quantizer_matches(
            lambda a: tk.compress_v(a, tcfg), lambda a: rk.compress_v(a, cfg),
            lambda *a: tk.decompress_v(*a, tcfg), lambda *a: rk.decompress_v(*a, cfg), x)


# ---------------------------------------------------------------------------
# repacking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", [0.05, 0.1, 0.2, 0.5, 1.0])
def test_repack_matches_reference(rel):
    """Every mode's permutation byte-exact against the reference's host
    loop, batched over [2, n, 64, D] blocks, packs 4/8/16. At the coarse
    rels many greedy seeds tie exactly; a float64 sum in another order
    than numpy's pairwise one picks another seed there."""
    k, v = kv_blocks(int(rel * 100), 12, 128)
    cfg = rq.QuantConfig(rel_scale=rel)
    qk = np.stack([rbf._np_quant_tokenwise(b, cfg)[0] for b in k])
    qv = np.stack([rbf._np_quant_tokenwise(b, cfg)[0] for b in v])
    tqk = torch.from_numpy(qk).reshape(2, -1, 64, 128)
    tqv = torch.from_numpy(qv).reshape(2, -1, 64, 128)
    modes = list(tr.REPACKERS)
    assert modes == list(rr.REPACKERS)
    for pack in (4, 8, 16):
        for mode in modes:
            got = tr.repack(tqk, tqv, pack, mode).reshape(-1, 64)
            assert got.dtype == torch.int64
            want = np.stack([rr.repack(a, b, pack, mode) for a, b in zip(qk, qv)])
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{mode} {pack}")
    one = tr.median_repack(torch.from_numpy(qv[0]), 8)
    np.testing.assert_array_equal(one.numpy(), rr.median_repack(qv[0], 8))
    with pytest.raises(ValueError):
        tr.repack(tqk, tqv, 8, "bogus")


def test_greedy_repack_clustered_and_chunked(monkeypatch):
    """Interleaved clusters, odd widths and ints past the quantizer's
    range; the batch cut into chunks of one block gives the same perms."""
    rng = np.random.default_rng(7)
    qs = []
    for d in (5, 16, 33):
        a = rng.integers(0, 2, size=(16, d))
        b = rng.integers(500, 900, size=(16, d))
        q = np.empty((32, d), dtype=np.int64)
        q[0::2], q[1::2] = a, b
        qs.append(q)
    for q in qs:
        for pack in (2, 8):
            want = rr.greedy_repack(q, pack)
            np.testing.assert_array_equal(tr.greedy_repack(torch.from_numpy(q), pack).numpy(),
                                          want)
    batch = np.stack([rng.integers(0, 9, size=(32, 16)) for _ in range(5)])
    whole = tr.greedy_repack(torch.from_numpy(batch), 4)
    monkeypatch.setattr(tr, "GREEDY_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(tr.greedy_repack(torch.from_numpy(batch), 4).numpy(),
                                  whole.numpy())
    np.testing.assert_array_equal(whole.numpy(), [rr.greedy_repack(q, 4) for q in batch])


def test_pairwise_sum_is_numpys():
    rng = np.random.default_rng(8)
    for n in (1, 7, 8, 9, 64, 127, 128, 129, 200, 256, 257, 600):
        x = rng.normal(size=(20, n)) * 10.0 ** rng.uniform(-6, 6, size=(20, n))
        np.testing.assert_array_equal(tr.pairwise_sum(torch.from_numpy(x)).numpy(),
                                      x.sum(axis=1))


# ---------------------------------------------------------------------------
# the block stream
# ---------------------------------------------------------------------------


def assert_stream_equal(got: tbf.CompressedKVStream, want: rbf.CompressedKVStream):
    g = convert.stream_to_numpy(got)
    assert (g["pack_size"], g["repack_mode"]) == (want.pack_size, want.repack_mode)
    assert g["k_quant"] == dataclasses.asdict(want.k_quant)
    assert g["v_quant"] == dataclasses.asdict(want.v_quant)
    assert len(g["entries"]) == len(want.entries)
    for ge, we in zip(g["entries"], want.entries):
        assert (ge["head"], ge["token_start"], ge["n_tokens"]) == (
            we.head, we.token_start, we.n_tokens)
        for name in ("perm", "k_meta", "v_meta"):
            assert ge[name].dtype == getattr(we, name).dtype, name
            np.testing.assert_array_equal(ge[name], getattr(we, name), err_msg=name)
        for name in ("k_block", "v_block"):
            for f in dataclasses.fields(rb.PackedBlock):
                np.testing.assert_array_equal(ge[name][f.name],
                                              getattr(getattr(we, name), f.name))


@pytest.mark.parametrize("mode,pack", [("greedy_joint", 8), ("median_v", 8),
                                       ("none", 16), ("greedy_v", 4)])
def test_stream_matches_reference(mode, pack):
    """Three heads of three 64-token blocks: ``append`` and the batched
    ``extend`` both equal the reference's stream; decode (float64, exact),
    accounting and serialization equal; the stream converts both ways."""
    H, nb, D = 3, 3, 64
    k, v = kv_blocks(9, H * nb, D)
    k, v = k.reshape(H, nb * 64, D), v.reshape(H, nb * 64, D)
    quant = dict(k_quant=rq.QuantConfig(rel_scale=0.15), v_quant=rq.QuantConfig(bits=3))
    want = rbf.CompressedKVStream(pack_size=pack, repack_mode=mode, **quant)
    got = tbf.CompressedKVStream(pack_size=pack, repack_mode=mode, **{
        n: tq.QuantConfig(**dataclasses.asdict(c)) for n, c in quant.items()})
    for h in range(H):
        for b in range(nb):
            sl = slice(b * 64, (b + 1) * 64)
            want.append(k[h, sl], v[h, sl], head=h, token_start=b * 64)
            got.append(torch.from_numpy(k[h, sl]), torch.from_numpy(v[h, sl]),
                       head=h, token_start=b * 64)
    batched = tbf.CompressedKVStream(pack_size=pack, repack_mode=mode,
                                     k_quant=got.k_quant, v_quant=got.v_quant)
    batched.extend(torch.from_numpy(k), torch.from_numpy(v))
    for s in (got, batched):
        assert_stream_equal(s, want)
    assert_stream_equal(convert.stream_from_numpy(want, "cpu"), want)
    assert_stream_equal(convert.stream_from_numpy(convert.stream_to_numpy(got), "cpu"),
                        want)
    for i in range(len(want.entries)):
        for restore in (False, True):
            for g, w in zip(got.decode_block(i, restore), want.decode_block(i, restore)):
                assert g.dtype == torch.float64
                np.testing.assert_array_equal(g.numpy(), w)
    for h in range(H):
        for g, w in zip(got.decode_head(h, True), want.decode_head(h, True)):
            np.testing.assert_array_equal(g.numpy(), w)
    assert got.total_bits() == want.total_bits()
    assert got.raw_bits() == want.raw_bits()
    assert got.compression_ratio() == want.compression_ratio()
    flat, directory = got.serialize()
    wflat, wdir = want.serialize()
    np.testing.assert_array_equal(u32(flat), wflat)
    assert directory == wdir


def test_stream_error_bound_and_empty():
    """|x - decode| <= scale / 2 (+ the f32 rounding of scale and zero)
    on every value; an empty stream serializes to nothing."""
    k, v = kv_blocks(10, 4, 128)
    s = tbf.CompressedKVStream()
    s.extend(torch.from_numpy(k), torch.from_numpy(v))
    for i, e in enumerate(s.entries):
        dk, dv = s.decode_block(i, restore_order=True)
        for x, d, meta in ((k[i], dk, e.k_meta), (v[i], dv, e.v_meta)):
            scale = meta[torch.argsort(e.perm), 0].double().numpy()[:, None]
            err = np.abs(d.numpy() - x)
            assert (err <= scale * (0.5 + 2 ** -20) + 4 * np.spacing(np.abs(x))).all()
    flat, directory = tbf.CompressedKVStream().serialize()
    assert flat.numel() == 0 and flat.dtype == torch.int32 and directory == []


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------


def test_synthetic_data_matches_reference():
    a = zipf_token_batch(np.random.default_rng(0), 4, 32, 1000)
    b = r_zipf(np.random.default_rng(0), 4, 32, 1000)
    assert a.dtype == b.dtype and (a == b).all()
    for kw in ({}, K_PROFILE, V_PROFILE):
        x = synthetic_kv(np.random.default_rng(11), 2, 3, 96, 32, **kw)
        y = r_synthetic_kv(np.random.default_rng(11), 2, 3, 96, 32, **kw)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for host in (0, 1):
        s = ShardedTokenStream(vocab=500, batch_per_host=2, seq=16, host_id=host,
                               n_hosts=2, seed=3)
        r = RStream(vocab=500, batch_per_host=2, seq=16, host_id=host, n_hosts=2, seed=3)
        for _ in range(3):
            got, want = s.next_batch(), r.next_batch()
            for key in ("tokens", "labels"):
                assert got[key].tobytes() == want[key].tobytes()
        assert s.state() == r.state()
    # restart from a saved state reproduces the next batch; hosts differ
    s1 = ShardedTokenStream(vocab=100, batch_per_host=2, seq=16, seed=3)
    [s1.next_batch() for _ in range(4)]
    state = s1.state()
    nxt = s1.next_batch()
    s2 = ShardedTokenStream(vocab=100, batch_per_host=2, seq=16, seed=3)
    s2.restore(state)
    assert (s2.next_batch()["tokens"] == nxt["tokens"]).all()
    h0 = ShardedTokenStream(vocab=1000, batch_per_host=2, seq=64, host_id=0, n_hosts=2)
    h1 = ShardedTokenStream(vocab=1000, batch_per_host=2, seq=64, host_id=1, n_hosts=2)
    assert not (h0.next_batch()["tokens"] == h1.next_batch()["tokens"]).all()
