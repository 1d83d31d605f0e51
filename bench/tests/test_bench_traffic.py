"""The traffic generator: the same seed gives the same cohorts, every seed
the same work, and a mix file with an unknown key is refused."""

import json

import numpy as np
import pytest

from bench import generator
from bench.tests.helpers import BENCH


def _mixes():
    return {p.stem: json.loads(p.read_text())
            for p in (BENCH / "traffic").glob("*.json")}


@pytest.mark.parametrize("mix", sorted(_mixes()))
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**31, -4])
def test_same_seed_same_cohorts(mix, seed):
    m = generator.check(_mixes()[mix])
    for i in (0, 1, 5):
        a = generator.cohort(m, 65536, seed, i)
        b = generator.cohort(m, 65536, seed, i)
        assert np.array_equal(a.prompts, b.prompts)
        assert np.array_equal(a.anchors, b.anchors)
        assert np.array_equal(a.keep, b.keep)
        assert a.prompts.dtype == np.int32
        assert a.prompts.shape[0] == m["batch"]
        assert 0 <= a.prompts.min() and a.prompts.max() < 65536


@pytest.mark.parametrize("mix", sorted(_mixes()))
def test_every_seed_offers_the_same_lengths(mix):
    m = _mixes()[mix]
    n = len(m["prompt_lens"])
    for seed in (1, 2, 2**31 + 1):
        for block in range(4):
            lens = [generator.cohort(m, 1000, seed, block * n + j).prompt_len
                    for j in range(n)]
            assert sorted(lens) == sorted(m["prompt_lens"])


def test_seeds_differ():
    m = _mixes()["stream"]
    a = generator.cohort(m, 65536, 1, 0)
    b = generator.cohort(m, 65536, 2, 0)
    assert not np.array_equal(a.anchors, b.anchors)


def test_stream_feeds_the_anchor_and_chat_its_own_token():
    s = generator.cohort(_mixes()["stream"], 65536, 3, 0)
    share = s.keep.mean()
    assert 0.9 < share < 1.0
    # prompts are uniform over the vocabulary in every mix
    assert (s.prompts == s.anchors[:, None]).mean() < 0.01
    greedy = np.full(s.anchors.shape, 5, np.int32)
    fed = s.feed(1, greedy)
    assert np.array_equal(fed, np.where(s.keep[0], s.anchors, 5))
    c = generator.cohort(_mixes()["chat"], 65536, 3, 0)
    assert not c.keep.any()
    greedy = np.arange(c.anchors.size, dtype=np.int32)
    assert np.array_equal(c.feed(4, greedy), greedy)


def test_a_mix_with_a_wrong_key_is_refused():
    m = dict(_mixes()["chat"], rate=3)
    with pytest.raises(ValueError):
        generator.check(m)
    m = dict(_mixes()["chat"], feed="sampled")
    with pytest.raises(ValueError):
        generator.check(m)
