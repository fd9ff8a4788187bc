"""The torch port's MoE configs (qwen2-moe-a2.7b and moonshot-v1-16b-a3b
smoke) under speculative decode (spec_k 4: verify passes over windows of
5, a drafter replaying the plain run with every third proposal wrong):
bitwise equal to plain decode for every request whose verify passes
dropped no routed choice (a pass routes B x 5 tokens, so the expert
capacity may bind there; a decode step at B <= 8 never binds it), and
such requests exist; against the reference's speculative server under the
plain run's margins and the routing rule (``torch_moe_helpers``)."""
import numpy as np
import pytest

from repro.serving import engine as je
from repro_torch.serving import engine as te
from torch_moe_helpers import (  # noqa: F401  (smoke: the fixture)
    Replay,
    against_reference,
    engines,
    requests,
    run,
    smoke,
)


def test_spec_serving_matches_plain_and_reference(smoke):
    cfg, _, tcfg, _, _ = smoke
    with pytest.MonkeyPatch.context() as mp:
        plain, _ = engines(smoke, "chunked")
        p, tp = run(plain, requests(te.Request, tcfg.vocab, "spec"), mp)
    outs = {tuple(int(t) for t in r.tokens): list(r.output) for r in p.done.values()}
    with pytest.MonkeyPatch.context() as mp:
        spec, jspec = engines(smoke, "spec")
        assert spec.rows == plain.rows == 5  # the same decode GEMM heights
        a, ta = run(spec, requests(te.Request, tcfg.vocab, "spec"), mp,
                    drafter=Replay(outs, tcfg.vocab))
        b, tb = run(jspec, requests(je.Request, cfg.vocab, "spec"), mp,
                    drafter=Replay(outs, cfg.vocab))
    assert a.stats.spec_launches > 0 and 0 < a.stats.spec_accepted < a.stats.spec_drafted
    assert {c.T for c in ta.calls if c.site == "verify"} == {2 * 5}
    clean = sorted(set(a.done) - ta.verify_dropped)
    assert clean, "every request had a verify drop"
    for rid in clean:
        np.testing.assert_array_equal(a.done[rid].output, p.done[rid].output,
                                      err_msg=f"spec != plain, request {rid}")
    assert against_reference(a, b, ta, tb, margins=tp.margins, rids=clean) >= 4
