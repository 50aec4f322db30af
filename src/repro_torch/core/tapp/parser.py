"""YAML → :class:`TappScript` parser.

The concrete syntax follows the paper's examples (Figs. 5, 6, 8): a tAPP
script is a YAML list of single-key mappings ``{policy_tag: [...blocks...]}``
where the block list may be followed by tag-level ``strategy`` / ``followup``
entries (YAML's indentation in the paper attaches them to the tag).

Because the paper writes tag options *inside* the same list as blocks, e.g.::

    - couchdb_query:
      - workers: ...
        strategy: random
      - workers: ...
      followup: fail          # <- tag level

real-world YAML parsers read that trailing scalar differently; we accept both
the list-item form (``- followup: fail``) and a mapping form::

    - couchdb_query:
        blocks: [...]
        strategy: best_first
        followup: fail

as well as the paper-faithful inline form where tag-level keys appear as the
final entries of the block list.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Tuple

import yaml

from repro_torch.core.tapp.ast import (
    Affinity,
    AntiAffinity,
    Block,
    ControllerClause,
    FollowupKind,
    Invalidate,
    OnOverload,
    Strategy,
    TagPolicy,
    TappScript,
    TopologyTolerance,
    WorkerItem,
    WorkerRef,
    WorkerSet,
    affinity_from_value,
    invalidate_from_text,
)


class TappParseError(ValueError):
    """Raised on malformed tAPP scripts, with a path for debuggability."""

    def __init__(self, message: str, path: str = "") -> None:
        self.path = path
        super().__init__(f"{path}: {message}" if path else message)


_TAG_LEVEL_KEYS = {"strategy", "followup", "on-overload"}
_CONSTRAINT_KEYS = {"invalidate", "affinity", "anti-affinity"}
_BLOCK_KEYS = (
    {"controller", "topology_tolerance", "workers", "strategy", "priority"}
    | _CONSTRAINT_KEYS
)


def parse_tapp(text: str) -> TappScript:
    """Parse a tAPP YAML document into a validated AST."""
    try:
        doc = yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise TappParseError(f"invalid YAML: {e}") from e
    if doc is None:
        return TappScript(tags=(), source=text)
    if not isinstance(doc, list):
        raise TappParseError(
            f"a tAPP script must be a YAML list of tag policies; got {type(doc).__name__}"
        )
    tags: List[TagPolicy] = []
    for i, entry in enumerate(doc):
        path = f"$[{i}]"
        if not isinstance(entry, Mapping) or not entry:
            raise TappParseError(
                "each top-level entry must be a mapping "
                "'{policy_tag: blocks}'",
                path,
            )
        # YAML parses the paper's trailing tag options (e.g. a dedented
        # 'followup: fail' after the block list) as sibling keys of the
        # tag key; accept them as tag-level options.
        tag_keys = [k for k in entry if k not in _TAG_LEVEL_KEYS]
        if len(tag_keys) != 1:
            raise TappParseError(
                "each top-level entry must contain exactly one policy tag "
                f"(plus optional {sorted(_TAG_LEVEL_KEYS)}); got keys "
                f"{sorted(map(str, entry.keys()))}",
                path,
            )
        tag_name = tag_keys[0]
        if not isinstance(tag_name, str) or not tag_name:
            raise TappParseError("policy tag must be a non-empty string", path)
        options = {k: v for k, v in entry.items() if k in _TAG_LEVEL_KEYS}
        tags.append(_parse_tag(str(tag_name), entry[tag_name], path, options))
    try:
        return TappScript(tags=tuple(tags), source=text)
    except ValueError as e:
        raise TappParseError(str(e)) from e


def parse_tapp_file(path: str) -> TappScript:
    with open(path, "r", encoding="utf-8") as fh:
        return parse_tapp(fh.read())


# ---------------------------------------------------------------------------


def _parse_tag(
    tag: str,
    body: Any,
    path: str,
    options: Optional[Mapping[str, Any]] = None,
) -> TagPolicy:
    path = f"{path}.{tag}"
    strategy: Optional[Strategy] = None
    followup: Optional[FollowupKind] = None
    on_overload: Optional[OnOverload] = None
    block_items: List[Any] = []
    if options:
        if "strategy" in options:
            strategy = _parse_strategy(options["strategy"], path)
        if "followup" in options:
            followup = _parse_followup(options["followup"], path)
        if "on-overload" in options:
            on_overload = _parse_on_overload(options["on-overload"], path)

    if isinstance(body, Mapping):
        # mapping form: {blocks: [...], strategy: ..., followup: ...}
        extra = set(body) - ({"blocks"} | _TAG_LEVEL_KEYS)
        if extra:
            raise TappParseError(f"unknown tag keys {sorted(extra)}", path)
        block_items = list(body.get("blocks") or [])
        if "strategy" in body:
            strategy = _parse_strategy(body["strategy"], path)
        if "followup" in body:
            followup = _parse_followup(body["followup"], path)
        if "on-overload" in body:
            on_overload = _parse_on_overload(body["on-overload"], path)
    elif isinstance(body, list):
        for j, item in enumerate(body):
            ipath = f"{path}[{j}]"
            if not isinstance(item, Mapping):
                raise TappParseError(
                    f"expected a mapping (block or tag option); got {type(item).__name__}",
                    ipath,
                )
            keys = set(item.keys())
            if keys <= _TAG_LEVEL_KEYS:
                # '- strategy: ...' / '- followup: ...' list items
                if "strategy" in item:
                    if strategy is not None:
                        raise TappParseError("duplicate tag-level strategy", ipath)
                    strategy = _parse_strategy(item["strategy"], ipath)
                if "followup" in item:
                    if followup is not None:
                        raise TappParseError("duplicate tag-level followup", ipath)
                    followup = _parse_followup(item["followup"], ipath)
                if "on-overload" in item:
                    if on_overload is not None:
                        raise TappParseError(
                            "duplicate tag-level on-overload", ipath
                        )
                    on_overload = _parse_on_overload(item["on-overload"], ipath)
            else:
                block_items.append(item)
    else:
        raise TappParseError(
            f"tag body must be a list of blocks; got {type(body).__name__}", path
        )

    if not block_items:
        raise TappParseError("tag must define at least one block", path)

    blocks = tuple(
        _parse_block(item, f"{path}[{j}]") for j, item in enumerate(block_items)
    )
    try:
        return TagPolicy(
            tag=tag,
            blocks=blocks,
            strategy=strategy,
            followup=followup,
            on_overload=on_overload,
        )
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_block(item: Mapping[str, Any], path: str) -> Block:
    # The paper's YAML sometimes nests tag-level strategy/followup *after* the
    # workers key within the last block; here each block is its own mapping.
    extra = set(item) - _BLOCK_KEYS
    if extra:
        raise TappParseError(f"unknown block keys {sorted(extra)}", path)
    if "workers" not in item:
        raise TappParseError("block is missing the 'workers' key", path)

    controller: Optional[ControllerClause] = None
    if "controller" in item:
        label = item["controller"]
        if not isinstance(label, str) or not label:
            raise TappParseError("controller label must be a non-empty string", path)
        tolerance = TopologyTolerance.ALL
        if "topology_tolerance" in item:
            tolerance = _parse_tolerance(item["topology_tolerance"], path)
        controller = ControllerClause(label=label, topology_tolerance=tolerance)
    elif "topology_tolerance" in item:
        raise TappParseError(
            "topology_tolerance requires a controller clause", path
        )

    strategy = _parse_strategy(item["strategy"], path) if "strategy" in item else None
    invalidate = (
        _parse_invalidate(item["invalidate"], path) if "invalidate" in item else None
    )
    priority: Optional[int] = None
    if "priority" in item:
        raw = item["priority"]
        if isinstance(raw, bool) or not isinstance(raw, int) or raw < 0:
            raise TappParseError(
                f"priority must be a non-negative integer; got {raw!r}", path
            )
        priority = raw
    affinity, anti_affinity = _parse_affinities(item, path)
    workers = _parse_workers(item["workers"], f"{path}.workers")
    try:
        return Block(
            workers=workers,
            controller=controller,
            strategy=strategy,
            invalidate=invalidate,
            affinity=affinity,
            anti_affinity=anti_affinity,
            priority=priority,
        )
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_workers(body: Any, path: str) -> Tuple[WorkerItem, ...]:
    if body is None:
        # 'workers:' with nothing below it — treat as the blank set (all workers).
        return (WorkerSet(label=None),)
    if not isinstance(body, list):
        raise TappParseError(
            f"workers must be a list of 'wrk:'/'set:' items; got {type(body).__name__}",
            path,
        )
    items: List[WorkerItem] = []
    for j, entry in enumerate(body):
        ipath = f"{path}[{j}]"
        if not isinstance(entry, Mapping):
            raise TappParseError(
                f"workers item must be a mapping; got {type(entry).__name__}", ipath
            )
        keys = set(entry.keys())
        if "wrk" in keys:
            extra = keys - ({"wrk"} | _CONSTRAINT_KEYS)
            if extra:
                raise TappParseError(f"unknown wrk keys {sorted(extra)}", ipath)
            label = entry["wrk"]
            if not isinstance(label, str) or not label:
                raise TappParseError("wrk label must be a non-empty string", ipath)
            inv = (
                _parse_invalidate(entry["invalidate"], ipath)
                if "invalidate" in entry
                else None
            )
            aff, anti = _parse_affinities(entry, ipath)
            items.append(
                WorkerRef(
                    label=label, invalidate=inv, affinity=aff, anti_affinity=anti
                )
            )
        elif "set" in keys:
            extra = keys - ({"set", "strategy"} | _CONSTRAINT_KEYS)
            if extra:
                raise TappParseError(f"unknown set keys {sorted(extra)}", ipath)
            label = entry["set"]
            if label is not None and (not isinstance(label, str) or not label):
                raise TappParseError(
                    "set label must be a non-empty string or blank (all workers)",
                    ipath,
                )
            strat = (
                _parse_strategy(entry["strategy"], ipath)
                if "strategy" in entry
                else None
            )
            inv = (
                _parse_invalidate(entry["invalidate"], ipath)
                if "invalidate" in entry
                else None
            )
            aff, anti = _parse_affinities(entry, ipath)
            items.append(
                WorkerSet(
                    label=label,
                    strategy=strat,
                    invalidate=inv,
                    affinity=aff,
                    anti_affinity=anti,
                )
            )
        else:
            raise TappParseError(
                f"workers item must have a 'wrk' or 'set' key; got {sorted(keys)}",
                ipath,
            )
    return tuple(items)


def _parse_strategy(value: Any, path: str) -> Strategy:
    # Accept the paper's 'best-first' spelling variant (Fig. 8) too.
    text = str(value).strip().replace("-", "_")
    try:
        return Strategy.parse(text)
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_followup(value: Any, path: str) -> FollowupKind:
    try:
        return FollowupKind.parse(str(value))
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_on_overload(value: Any, path: str) -> OnOverload:
    try:
        return OnOverload.parse(str(value))
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_tolerance(value: Any, path: str) -> TopologyTolerance:
    try:
        return TopologyTolerance.parse(str(value))
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_invalidate(value: Any, path: str) -> Invalidate:
    try:
        return invalidate_from_text(str(value))
    except ValueError as e:
        raise TappParseError(str(e), path) from e


def _parse_affinities(
    entry: Mapping[str, Any], path: str
) -> Tuple[Optional[Affinity], Optional[AntiAffinity]]:
    """Parse the optional affinity / anti-affinity clauses of one mapping."""
    affinity: Optional[Affinity] = None
    anti: Optional[AntiAffinity] = None
    if "affinity" in entry:
        try:
            affinity = Affinity(affinity_from_value("affinity", entry["affinity"]))
        except ValueError as e:
            raise TappParseError(str(e), path) from e
    if "anti-affinity" in entry:
        try:
            anti = AntiAffinity(
                affinity_from_value("anti-affinity", entry["anti-affinity"])
            )
        except ValueError as e:
            raise TappParseError(str(e), path) from e
    return affinity, anti
