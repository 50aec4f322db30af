"""The one traffic generator: a mix file's parameters and a seed in, a schedule out.

A mix file (``servebench/traffic/<name>.json``) sets the loop (``open``:
arrivals on a schedule; ``closed``: callers that each invoke again when
their reply comes), the rate or the callers, the length distributions,
the tags, the warm-up and the drain limit.

Every seed gets the same work: the multiset of request sizes, tags and
gaps between arrivals is drawn from the mix's own ``population_seed``,
and the run's seed only orders it and draws the prompts' token ids. Two
seeds then differ in the order the same requests come in, not in how
much there is to do. A mix with ``"shuffle_block": k`` keeps the arrival
times themselves, and each run of ``k`` consecutive requests' sizes and
tags, the same for every seed, and the seed orders the sizes within each
run: the load over each second is then the seed's alone in its order,
not in how many requests and tokens it holds. Prompt lengths are rounded up to the mix's ``grid``
so that the engine meets a known set of prompt lengths, each of which
the harness warms up before the window.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Item:
    """One request to be sent: when (open loop), its sizes and its tag."""

    arrival_s: float          # seconds after the schedule starts (open loop)
    prompt_len: int
    max_new_tokens: int
    tag: Optional[str]
    tokens: np.ndarray        # the prompt's token ids


def _draw(dist: Dict, rng: np.random.Generator, n: int) -> np.ndarray:
    kind = dist["dist"]
    if kind == "lognormal":
        x = rng.lognormal(math.log(dist["median"]), dist["sigma"], n)
    elif kind == "uniform":
        x = rng.integers(dist["min"], dist["max"] + 1, n)
    elif kind == "fixed":
        x = np.full(n, dist["value"])
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(x), dist.get("min", 1), dist.get("max", 1 << 30)).astype(np.int64)


def snap(lengths: np.ndarray, dist: Dict) -> np.ndarray:
    """Round prompt lengths up to the distribution's grid, within its limits."""
    grid = dist.get("grid", 1)
    out = -(-lengths // grid) * grid
    return np.minimum(out, dist.get("max", 1 << 30) // grid * grid).astype(np.int64)


def _tags(mix: Dict, rng: np.random.Generator, n: int) -> List[Optional[str]]:
    names = list(mix["tags"])
    probs = np.asarray([mix["tags"][t] for t in names], dtype=np.float64)
    picks = rng.choice(len(names), size=n, p=probs / probs.sum())
    return [names[i] or None for i in picks]


def _sizes(mix: Dict, rng: np.random.Generator, n: int):
    prompt = snap(_draw(mix["prompt"], rng, n), mix["prompt"])
    output = _draw(mix["output"], rng, n)
    output = np.minimum(output, mix["max_total"] - prompt)
    return prompt, output


def open_loop(mix: Dict, seed: int, horizon_s: float, vocab: int,
              rate: Optional[float] = None) -> List[Item]:
    """Poisson arrivals at ``rate`` (default the mix's) over ``horizon_s``
    seconds, in arrival order. The ``rate × horizon_s`` gaps are scaled to
    fill the horizon exactly (a Poisson process given its count), so every
    seed offers the rate until the window closes. With the mix's
    ``shuffle_block`` the gaps keep their drawn order and the seed permutes
    the requests within each block of that many."""
    rate = float(mix["rate_per_s"] if rate is None else rate)
    n = int(math.ceil(rate * horizon_s))
    pop = np.random.default_rng(mix["population_seed"])
    gaps = pop.exponential(1.0 / rate, n)
    gaps *= horizon_s / gaps.sum()
    prompt, output = _sizes(mix, pop, n)
    tags = _tags(mix, pop, n)
    run = np.random.default_rng([int(seed), 1])
    block = mix.get("shuffle_block")
    if block:
        order = np.concatenate([start + run.permutation(min(block, n - start))
                                for start in range(0, n, block)])
    else:
        gaps = gaps[run.permutation(n)]
        order = run.permutation(n)
    arrivals = np.cumsum(gaps) - gaps   # the first at 0, the last a gap before the horizon
    items = []
    for t, i in zip(arrivals, order):
        tokens = run.integers(0, vocab, int(prompt[i]), dtype=np.int64).astype(np.int32)
        items.append(Item(float(t), int(prompt[i]), int(output[i]), tags[i], tokens))
    return items


def closed_loop(mix: Dict, seed: int, count: int, vocab: int) -> List[Item]:
    """``count`` invocations in the order callers take them: each picks one of
    the mix's functions by Zipf popularity, with that function's prompt
    length and tag, and an output length from the mix."""
    funcs = mix["functions"]
    pop = np.random.default_rng(mix["population_seed"])
    weights = 1.0 / np.arange(1, len(funcs) + 1) ** mix["zipf_s"]
    picks = pop.choice(len(funcs), size=count, p=weights / weights.sum())
    output = _draw(mix["output"], pop, count)
    run = np.random.default_rng([int(seed), 2])
    order = run.permutation(count)
    items = []
    for i in order:
        f = funcs[picks[i]]
        tokens = run.integers(0, vocab, f["prompt"], dtype=np.int64).astype(np.int32)
        items.append(Item(0.0, f["prompt"], int(output[i]), f.get("tag") or None, tokens))
    return items
