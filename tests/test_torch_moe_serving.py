"""The torch port's MoE configs (qwen2-moe-a2.7b and moonshot-v1-16b-a3b
smoke) served through ``Engine`` + ``SlotServer`` with chunked admission
(pages of 128: a 140-token prompt admits in a full chunk and a short
one), dense and paged, against the JAX reference's engine; paged == dense
bitwise within the port.

Against the reference (``torch_moe_helpers``): the calibrated specs
byte-exact; every admission's logits within LOGIT_ATOL; every request's
tokens equal until its first top-2 logit margin below LOGIT_ATOL in the
port's run (the margin rule) or its first routing difference, which must
sit within ROUTE_NOISE of a top-k tie; no routed token of the port within
GAP of its tie. Paged == dense at pages of 256, where the plain K5 tiles
as the plain K2 (on the card they are equal at every page size). The
monolithic, prefix and preemption modes are in
tests/test_torch_moe_sched.py, speculative decode in
tests/test_torch_moe_spec.py."""
import dataclasses

import numpy as np
import pytest

from repro.serving import engine as je
from repro_torch.serving import engine as te
from torch_moe_helpers import (  # noqa: F401  (smoke: the fixture)
    PAGE,
    Replay,
    against_reference,
    engines,
    outputs,
    port_engine,
    requests,
    run,
    smoke,
)


def test_chunked_dense_and_paged_match_reference(smoke):
    cfg, _, tcfg, _, _ = smoke
    compared = 0
    with pytest.MonkeyPatch.context() as mp:
        for mode in ("chunked", "paged"):
            port, ref = engines(smoke, mode)
            a, ta = run(port, requests(te.Request, tcfg.vocab, mode), mp)
            b, tb = run(ref, requests(je.Request, cfg.vocab, mode), mp)
            compared += against_reference(a, b, ta, tb)
            # a full chunk and a short final one, each routing its own tokens
            assert {c.T for c in ta.calls if c.site == "chunk"} >= {PAGE, 140 - PAGE}
    assert compared >= 8, compared


def test_paged_equals_dense_bitwise(smoke):
    """Chunked admission at pages of 256: the paged run's tokens equal the
    dense run's bitwise."""
    tcfg = smoke[2]
    with pytest.MonkeyPatch.context() as mp:
        a, b = (run(port_engine(smoke, mode, page_size=256),
                    requests(te.Request, tcfg.vocab, mode), mp)[0]
                for mode in ("chunked", "paged"))
    assert a.cache[0].pages is None and b.cache[0].pages is not None
    for rid, out in outputs(a).items():
        np.testing.assert_array_equal(b.done[rid].output, out,
                                      err_msg=f"paged != dense, request {rid}")
