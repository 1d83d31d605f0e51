"""The check that decides `correct`, on tiny cells on the CPU: the
reference agrees with the program's served tokens and logits, disagrees
once one int8 code is flipped, the control (the reference in float8) comes
out not correct, and each fault a one-card serving cell can have turns
`correct` false: a step that leaves its state unchanged, half of the batch
left out, a token altered where it is produced."""

import numpy as np
import pytest
import torch

from bench import cell, generator, reference, weights
from bench.tests.helpers import tiny_config, tiny_mix, tiny_run, tiny_spec

FAMILIES = ["nemotron4_15b", "rwkv6_7b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_program_agrees_with_the_reference(name):
    r = tiny_run(name, precisions=("fp8",))
    assert r["correct"], r["check"]
    assert r["readings"]["logit_gap"] == 0.0
    # the control, put in the program's place, fails the tiny cell's limits
    # by the comparison a run applies
    assert r["readings"]["logit_gap.fp8"] > 1e-2
    assert r["readings"]["logit_gap_mean.fp8"] > 1e-3
    check, within = cell.compare(tiny_spec(name).limits, r["readings"],
                                 "fp8")
    assert not within, check


def _program_logits(name, flip_at=None):
    """The program's logits of one tiny cohort, step by step, and the
    reference's; with `flip_at`, one code of the first site's previous
    codes is changed before that decode step."""
    conf, mix = tiny_config(name), tiny_mix()
    params = weights.make(conf, 5, "cpu")
    prog = cell.Program(conf, mix, params, "cpu")
    c = generator.cohort(mix, conf["vocab"], 5, 0)
    prog.new_cohort()
    out = [prog.step.prefill(c.prompts)[:, -1].clone()]
    served = cell.greedy(out[0][:, None])
    fed = []
    for t in range(1, mix["decode_steps"] + 1):
        if t == flip_at:
            site = next(iter(prog.rcache.values()))
            site["prev_q"][0, 0, 3] += 1
        feed = c.feed(t, served)
        fed.append(feed)
        lg = prog.decode(feed)
        out.append(lg[:, 0].clone())
        served = cell.greedy(lg)
    seq = torch.as_tensor(np.concatenate([c.prompts, np.stack(fed, 1)], 1))
    ref = reference.logits(params, conf, seq, c.prompt_len)
    return torch.stack(out, 1), ref


@pytest.mark.parametrize("name", FAMILIES)
def test_one_flipped_code_is_seen(name):
    got, ref = _program_logits(name)
    assert torch.equal(got, ref)
    got, ref = _program_logits(name, flip_at=4)
    diff = (got - ref).abs().amax(dim=(0, 2))
    assert float(diff[:4].max()) == 0.0
    assert float(diff[4:].min()) > 1e-4


def _state_unchanged(prog):
    decode = prog.decode

    def stale(tokens):
        keep = [(t, t.clone()) for t in _leaves(prog.state)
                + _leaves(prog.rcache)]
        out = decode(tokens)
        for t, v in keep:
            t.copy_(v)
        return out
    prog.decode = stale


def _half_batch(prog):
    decode = prog.decode

    def half(tokens):
        out = decode(tokens).clone()
        b = out.shape[0]
        out[b // 2:] = out[:b - b // 2]
        return out
    prog.decode = half


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", FAMILIES)
def test_a_broken_step_is_not_correct(name, fault):
    r = tiny_run(name, program_hook=FAULTS[fault])
    assert not r["correct"], r["check"]
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("name", FAMILIES)
def test_an_altered_token_is_not_correct(name, monkeypatch):
    from repro_torch.serve import serve_step

    real = serve_step.greedy_sample

    def off_by_one(logits):
        tok = real(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(serve_step, "greedy_sample", off_by_one)
    r = tiny_run(name)
    assert not r["correct"], r["check"]
