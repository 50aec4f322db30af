"""Item-selection strategies (paper §3.3).

* ``best_first`` — order of appearance; send to the first valid item.
* ``random`` — fair random choice among valid items.
* ``platform`` — the host platform's default schedule. Faithful to
  OpenWhisk's *co-prime scheduling* (paper §2, footnotes 5–6): a function is
  hashed to a primary index ``hash % n``; on invalidation the index steps by
  a fixed *step size* that is co-prime with ``n``, cycling through all items.

Strategies are implemented as *orderings*: given the candidate items and an
invocation context, they yield the order in which candidates are tried. The
engine then applies invalidation in that order, which uniformly implements
"pick first valid" for all three strategies.

Orderings are consumed **lazily** (:func:`iter_ordered`). This matters
for ``random``: a lazily-evaluated Fisher–Yates draw
(:func:`iter_random`) yields one uniformly-chosen remaining item per
step, so a decision that accepts the first candidate consumes O(1) RNG
draws instead of paying a full O(n) shuffle. Both the interpreter and
the compiled engine (including its indexed fast path) consume random
orderings through the same draw sequence, so their RNG streams — and
therefore placements and traces — stay bit-identical. The draw uses
:func:`randbelow` (our own getrandbits rejection loop) rather than
``random.Random.shuffle`` so the stream is stable across CPython
versions.
"""
from __future__ import annotations

import functools
import hashlib
import random as _random
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, TypeVar

from repro_torch.core.tapp.ast import Strategy

T = TypeVar("T")


def stable_hash(text: str) -> int:
    """Deterministic 64-bit hash (Python's ``hash`` is salted per-process)."""
    return int.from_bytes(
        hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest(), "big"
    )


def _coprime_step(hash_value: int, n: int) -> int:
    """Smallest step > 1 co-prime with ``n`` derived from the hash (1 if n<=2)."""
    if n <= 2:
        return 1
    import math

    candidates = [s for s in range(2, n) if math.gcd(s, n) == 1]
    if not candidates:
        return 1
    return candidates[hash_value % len(candidates)]


@functools.lru_cache(maxsize=8192)
def coprime_order_cached(n: int, hash_value: int) -> Tuple[int, ...]:
    """Memoized co-prime schedule.

    The permutation is a pure function of ``(n, hash)``; real deployments
    see a bounded set of functions and cluster sizes, so the co-prime step
    search (O(n log n)) amortizes to a dict hit on the scheduling hot path.
    """
    if n <= 0:
        return ()
    primary = hash_value % n
    step = _coprime_step(hash_value, n)
    order, idx = [], primary
    for _ in range(n):
        order.append(idx)
        idx = (idx + step) % n
    # Co-primality guarantees a full cycle; assert in debug builds.
    assert len(set(order)) == n, (n, step, order)
    return tuple(order)


def coprime_order(n: int, hash_value: int) -> List[int]:
    """OpenWhisk co-prime schedule: primary ``hash % n``, then step cycles.

    The step size is co-prime with ``n`` so the cycle visits every index
    exactly once.
    """
    return list(coprime_order_cached(n, hash_value))


def randbelow(getrandbits, n: int) -> int:
    """Uniform int in ``[0, n)`` via getrandbits rejection sampling.

    The draw discipline every random ordering in the scheduler shares;
    implemented here (rather than leaning on ``Random._randbelow``) so
    the consumed bit stream is identical across CPython versions and
    across every evaluation path.
    """
    if n <= 1:
        return 0
    k = n.bit_length()
    r = getrandbits(k)
    while r >= n:
        r = getrandbits(k)
    return r


def iter_random(items: Sequence[T], rng: _random.Random) -> Iterator[T]:
    """Yield ``items`` in a uniformly random order, lazily.

    Incremental Fisher–Yates: each step draws one :func:`randbelow` and
    yields the item swapped into the current tail slot, so consuming the
    first ``k`` elements costs exactly ``k`` draws (the final element is
    free). Fully consumed, the sequence is a uniform permutation and the
    RNG stream equals a full Fisher–Yates shuffle — which is what makes
    partial consumption (stop at first valid candidate) free to early-out
    without desynchronizing any other evaluation path.
    """
    arr = list(items)
    getrandbits = rng.getrandbits
    for i in range(len(arr) - 1, 0, -1):
        j = randbelow(getrandbits, i + 1)
        arr[i], arr[j] = arr[j], arr[i]
        yield arr[i]
    if arr:
        yield arr[0]


def iter_ordered(
    items: Sequence[T],
    strategy: Strategy,
    *,
    rng: Optional[_random.Random] = None,
    function_hash: int = 0,
) -> Iterable[T]:
    """``items`` in strategy order, as a lazily-consumed iterable.

    The engine's ordering entry point: ``best_first`` and ``platform``
    consume no RNG; ``random`` draws lazily via :func:`iter_random`, so
    RNG consumption is proportional to candidates *tried*, not candidates
    *available*.
    """
    if strategy is Strategy.BEST_FIRST or not items:
        return items
    if strategy is Strategy.RANDOM:
        return iter_random(items, rng or _random.Random())
    if strategy is Strategy.PLATFORM:
        order = coprime_order_cached(len(items), function_hash)
        return (items[i] for i in order)
    if strategy is Strategy.WARM_FIRST:
        # Warm-first is warmth-aware and is ordered at the engine's call
        # sites (it needs worker pool state this module never sees). The
        # only route here is a tag-level warm-first — a validation error
        # — so degrade to the best_first identity order.
        return items
    raise ValueError(f"unknown strategy {strategy!r}")


def order_candidates(
    items: Sequence[T],
    strategy: Strategy,
    *,
    rng: Optional[_random.Random] = None,
    function_hash: int = 0,
) -> List[T]:
    """Return ``items`` in the order the strategy would try them.

    Eager counterpart of :func:`iter_ordered` (kept for callers that
    want a list); materializing a ``random`` ordering consumes the full
    draw sequence, exactly like exhausting the lazy iterator.
    """
    return list(
        iter_ordered(items, strategy, rng=rng, function_hash=function_hash)
    )
