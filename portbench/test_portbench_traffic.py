"""The traffic generator: the same seed gives the same requests; every seed
runs the same lengths in another order."""
import itertools
import json
import os

import numpy as np
import pytest

from portbench import traffic

HERE = os.path.dirname(os.path.abspath(__file__))


def _mix(name):
    with open(os.path.join(HERE, "mixes", name + ".json")) as f:
        return json.load(f)


def _take(mix, seed, n, vocab=49155):
    return list(itertools.islice(traffic.requests(mix, seed, vocab), n))


def test_lengths_are_log_spaced_between_the_ends():
    assert traffic.prompt_lengths(_mix("chat")) == [256, 307, 369, 443, 532, 638, 766, 920,
                                                   1104, 1326, 1591, 1911, 2294, 2753,
                                                   3305, 3968]
    p = traffic.prompt_lengths(_mix("prompt"))
    assert (p[0], p[-1], len(p), len(set(p))) == (550, 4096, 16, 16)
    # the medians of the cited trace: conversation 1020, code 1500
    assert np.median(traffic.prompt_lengths(_mix("chat"))) == pytest.approx(1020, rel=0.01)
    assert np.median(p) == pytest.approx(1500, rel=0.01)


def test_same_seed_same_requests():
    for mix in (_mix("chat"), _mix("prompt")):
        a, b = _take(mix, 2 ** 31 + 5, 20), _take(mix, 2 ** 31 + 5, 20)
        assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
        c = _take(mix, 2 ** 31 + 6, 20)
        assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))


def test_every_seed_runs_each_length_once_a_cycle():
    mix = _mix("chat")
    want = sorted(traffic.prompt_lengths(mix))
    for seed in (0, 1, 2 ** 31 + 11):
        reqs = _take(mix, seed, 32)
        assert sorted(len(p) for p, _ in reqs[:16]) == want
        assert [len(p) for p, _ in reqs[:16]] == [len(p) for p, _ in reqs[16:]]
        assert all(n == 128 for _, n in reqs)
        assert all(p.dtype == np.int32 and 0 <= p.min() and p.max() < 49155 for p, _ in reqs)


def test_warmup_covers_each_length_apart_from_the_window():
    mix = _mix("prompt")
    warm = traffic.warmup_prompts(mix, 7, 50280)
    assert [len(p) for p in warm] == traffic.prompt_lengths(mix)
    first = _take(mix, 7, 1, 50280)[0][0]
    assert not any(len(w) == len(first) and np.array_equal(w, first) for w in warm)


def test_check_sample_holds_the_longest_and_follows_the_seed():
    lengths = [5, 9, 3, 9, 7, 1, 8]
    finished = [0, 1, 2, 3, 4, 6]
    s = traffic.check_sample(finished, lengths, 3, 42)
    assert len(s) == 3 and 1 in s and set(s) <= set(finished)
    assert s == traffic.check_sample(finished, lengths, 3, 42)
    assert traffic.check_sample(finished, lengths, 99, 1) == finished
    assert traffic.check_sample([], lengths, 3, 1) == []


@pytest.mark.parametrize("change", [{"clients": 4}, {"batch": 2}, {"loop": "open"},
                                    {"rate_per_s": 3.0}, {"prompt_len": {"min": 8, "max": 40,
                                                                         "count": 4,
                                                                         "spacing": "zipf"}},
                                    {"max_cache_len": 40}])
def test_a_mix_the_harness_cannot_drive_is_refused(change):
    mix = _mix("../testdata/tiny-chat")
    assert traffic.validate(mix) is mix
    with pytest.raises(ValueError):
        traffic.validate({**mix, **change})
