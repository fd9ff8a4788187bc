"""The torch port's MoE configs (qwen2-moe-a2.7b and moonshot-v1-16b-a3b
smoke) through ``SlotServer`` with monolithic admission, the prefix cache
(a shared one-page system prompt) and preemption (two class-1 requests
fill the table, a class-0 arrival swaps one out), against the JAX
reference's engine (``torch_moe_helpers``: admission logits, tokens under
the margin and routing rules); the preempted run bitwise equal to the run
with preemption off (at max_batch <= 8 a decode step never binds the
expert capacity, so a row's routing does not depend on its neighbours).

Chunked == monolithic is no invariant for MoE: C follows the chunk's
length in one and the prompt's in the other (in the reference too), so it
is not asserted."""
import dataclasses

import numpy as np
import pytest

from repro.serving import engine as je
from repro_torch.serving import engine as te
from torch_moe_helpers import (  # noqa: F401  (smoke: the fixture)
    against_reference,
    engines,
    outputs,
    requests,
    run,
    smoke,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_monolithic_serving_matches_reference(smoke):
    cfg, _, tcfg, _, _ = smoke
    with pytest.MonkeyPatch.context() as mp:
        port, ref = engines(smoke, "mono")
        a, ta = run(port, requests(te.Request, tcfg.vocab, "mono"), mp)
        b, tb = run(ref, requests(je.Request, cfg.vocab, "mono"), mp)
    assert {c.site for c in ta.calls} == {"prefill", "decode"}
    assert against_reference(a, b, ta, tb) >= 4


def test_prefix_serving_matches_reference(smoke):
    """Later admissions hit the shared page and compute only their
    suffix."""
    cfg, _, tcfg, _, _ = smoke
    with pytest.MonkeyPatch.context() as mp:
        port, ref = engines(smoke, "prefix")
        a, ta = run(port, requests(te.Request, tcfg.vocab, "prefix"), mp)
        b, tb = run(ref, requests(je.Request, cfg.vocab, "prefix"), mp)
    assert a.stats.prefix_hits == b.stats.prefix_hits == 2
    assert against_reference(a, b, ta, tb) >= 4


def test_preempt_serving_matches_reference(smoke):
    """A class-0 arrival swaps a class-1 row out; the resumed row equals
    the run with preemption off, bitwise."""
    cfg, _, tcfg, _, _ = smoke
    with pytest.MonkeyPatch.context() as mp:
        port, ref = engines(smoke, "preempt")
        a, ta = run(port, requests(te.Request, tcfg.vocab, "preempt"), mp, preempt=True)
        b, tb = run(ref, requests(je.Request, cfg.vocab, "preempt"), mp, preempt=True)
        ctl_eng = te.Engine(port.cfg, port.params, port.pack_cfg, dataclasses.replace(
            port.ecfg, preempt=False))
        ctl, _ = run(ctl_eng, requests(te.Request, tcfg.vocab, "preempt"), mp)
    assert a.stats.preemptions >= 1 and a.stats.preemptions == b.stats.preemptions
    assert any(r.n_preempts for r in a.done.values())
    for rid, out in outputs(ctl).items():
        np.testing.assert_array_equal(a.done[rid].output, out,
                                      err_msg=f"resumed != uninterrupted, request {rid}")
    assert against_reference(a, b, ta, tb) >= 4
