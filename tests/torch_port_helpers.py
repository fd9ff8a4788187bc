"""Shared helpers of the torch-port tests (tests/test_torch_*.py): run the
JAX reference compiled without excess precision, carry its caches across
as numpy, compare caches leaf by leaf, and the greedy margin rule."""
import jax
import numpy as np

from repro_torch.convert import layer_cache_from_numpy, layer_cache_to_numpy

# XLA may keep bf16 intermediates in f32 ("excess precision"); the
# reference's written math rounds them, so compile without it.
EXACT = {"xla_allow_excess_precision": False}
# logits of the smoke model agree within four bf16 ulps at their
# magnitudes (2..4): bf16 matmuls summed in another order
LOGIT_ATOL = 0.0625


def margin(logits: np.ndarray) -> float:
    """Top-2 logit margin: under LOGIT_ATOL, rounding may flip the argmax."""
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def steps_before_tie(engine, tokens, n) -> tuple[list[int], int]:
    """The port's B=1 greedy run up to its first near-tie: (tokens so far,
    number of steps whose top-2 margin is at least LOGIT_ATOL)."""
    logits, cache = engine.prefill({"tokens": tokens[None]})
    out = []
    for i in range(n):
        row = logits.numpy()[0]
        if margin(row) < LOGIT_ATOL:
            return out, i
        out.append(int(row.argmax()))
        logits, cache = engine.decode(cache, np.asarray([[out[-1]]], np.int32))
    return out, n


def jit_exact(fn, **kw):
    return jax.jit(fn, compiler_options=EXACT, **kw)


def ref_cache_arrays(c) -> dict:
    """A reference ``LayerKVCache`` (dense or paged) -> the numpy dict of
    ``repro_torch.convert``."""
    def tiered(tc):
        if tc is None:
            return None
        return {"tiers": [{"payload": np.asarray(t.payload),
                           "mins": np.asarray(t.mins),
                           "shifts": np.asarray(t.shifts)} for t in tc.tiers],
                "chan_perm": np.asarray(tc.chan_perm),
                "scale": np.asarray(tc.scale), "zero": np.asarray(tc.zero)}

    opt = lambda a: None if a is None else np.asarray(a)
    pages = getattr(c, "pages", None)
    return {"k": tiered(c.k), "v": tiered(c.v), "raw_k": opt(c.raw_k),
            "raw_v": opt(c.raw_v), "resid_k": np.asarray(c.resid_k),
            "resid_v": np.asarray(c.resid_v), "n_comp": np.asarray(c.n_comp),
            "n_resid": np.asarray(c.n_resid),
            "pages": None if pages is None else {
                key: np.asarray(getattr(pages, key))
                for key in ("page_table", "free", "n_free", "ref")}}


def spec_tuple(spec):
    return (spec.widths, spec.counts, spec.pack_size)


def ref_cache_to_torch(c, pack_cfg, device="cpu"):
    """Carry a reference ``LayerKVCache`` into the port."""
    ks = vs = None
    if c.k is not None:
        ks, vs = spec_tuple(c.k.spec), spec_tuple(c.v.spec)
    return layer_cache_from_numpy(ref_cache_arrays(c), pack_cfg, ks, vs, device)


def _flat(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], d


def assert_zero_fma_close(got, want, scale, c: int):
    """Zero-points ``lo + c * scale`` that may differ only by the compiled
    reference fusing them into one FMA: within half an ulp of ``c * scale``
    (its dropped rounding) plus half an ulp of each result."""
    cs = np.abs(np.float32(c) * scale)
    bound = 0.5 * (np.spacing(cs) + np.spacing(np.abs(got)) + np.spacing(np.abs(want)))
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) - bound)


def assert_cache_equal(port_cache, ref_cache, fma_c=None):
    """Every leaf byte-exact. ``fma_c=(c_k, c_v)``: the zero-points of a
    compiled reference may differ by its FMA (``assert_zero_fma_close``)."""
    got = dict(_flat(layer_cache_to_numpy(port_cache)))
    want = dict(_flat(ref_cache_arrays(ref_cache)))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if fma_c is not None and name in ("k.zero", "v.zero"):
            c = fma_c[0] if name == "k.zero" else fma_c[1]
            assert_zero_fma_close(g, w, got[name[0] + ".scale"], c)
        else:
            bits = lambda a: np.atleast_1d(a).view(np.uint8)
            np.testing.assert_array_equal(bits(g), bits(w), err_msg=name)
