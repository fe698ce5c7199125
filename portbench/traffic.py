"""The one traffic generator: it reads a mix's data file and makes the
requests of a run from the seed.

A mix fixes a list of prompt lengths (``prompt_len``: ``count`` lengths
from ``min`` to ``max``, log-spaced) and how many greedy decode calls
follow each prompt.  Request ``i`` takes the length at place ``i % count``
of one seeded permutation of the list, so every seed runs the same lengths
in another order; the seed also draws every token id.  Warm-up prompts come
from a stream of their own, so warming up changes nothing in the window.

The harness drives one session in a closed loop, one prompt a call: a mix
states that with ``loop``, ``clients`` and ``batch``, and :func:`validate`
refuses a mix that asks for anything else, or holds a key it does not know,
before a run starts, so no key of a mix is ever ignored.
"""
from __future__ import annotations

import numpy as np

STREAM_REQUESTS, STREAM_WARMUP, STREAM_SAMPLE = 10, 11, 12
#: the keys a mix may hold, and the values the harness can drive of those
#: that are fixed (more clients, a batch, an open loop need generator code)
KEYS = {"why", "source", "loop", "clients", "batch", "prompt_len", "decode_tokens",
        "max_cache_len", "check_requests"}
DRIVEN = {"loop": "closed", "clients": 1, "batch": 1}
PROMPT_KEYS = {"min", "max", "count", "spacing"}


def validate(mix: dict, name: str = "mix") -> dict:
    """The mix, if the harness can run it as it asks; else ValueError."""
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"{name}: keys the generator does not read: {sorted(unknown)}")
    missing = (KEYS - {"why", "source"}) - set(mix)
    if missing:
        raise ValueError(f"{name}: keys missing: {sorted(missing)}")
    for k, v in DRIVEN.items():
        if mix[k] != v:
            raise ValueError(f"{name}: {k} = {mix[k]!r}, but the harness drives only "
                             f"{k} = {v!r}")
    p = mix["prompt_len"]
    if set(p) - PROMPT_KEYS or p.get("spacing", "log") != "log":
        raise ValueError(f"{name}: prompt_len takes min, max, count and spacing 'log'; "
                         f"got {p}")
    if p["min"] > p["max"] or p["max"] + mix["decode_tokens"] > mix["max_cache_len"]:
        raise ValueError(f"{name}: the longest request, {p['max']} + "
                         f"{mix['decode_tokens']} tokens, does not fit max_cache_len "
                         f"{mix['max_cache_len']}")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, stream]))


def prompt_lengths(mix: dict) -> list[int]:
    p = mix["prompt_len"]
    grid = np.exp(np.linspace(np.log(p["min"]), np.log(p["max"]), p["count"]))
    return [int(round(x)) for x in grid]


def requests(mix: dict, seed: int, vocab: int):
    """Endless (prompt int32 array, decode calls) pairs of the run."""
    lengths = prompt_lengths(mix)
    r = rng(seed, STREAM_REQUESTS)
    order = r.permutation(len(lengths))
    i = 0
    while True:
        n = lengths[order[i % len(lengths)]]
        yield r.integers(0, vocab, size=n, dtype=np.int32), int(mix["decode_tokens"])
        i += 1


def warmup_prompts(mix: dict, seed: int, vocab: int) -> list:
    """One prompt of each length the mix sends."""
    r = rng(seed, STREAM_WARMUP)
    return [r.integers(0, vocab, size=n, dtype=np.int32) for n in prompt_lengths(mix)]


def check_sample(finished: list[int], lengths: list[int], k: int, seed: int) -> list[int]:
    """Indices of the finished requests the check compares: ``k`` of them
    drawn from the seed, the longest always among them."""
    if not finished:
        return []
    longest = max(finished, key=lambda i: (lengths[i], -i))
    rest = [i for i in finished if i != longest]
    pick = rng(seed, STREAM_SAMPLE).permutation(len(rest))[:max(k - 1, 0)]
    return sorted([longest] + [rest[j] for j in pick])
