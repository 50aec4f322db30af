"""AST → YAML serialization (round-trips through :func:`parse_tapp`).

Used by the watcher to persist the canonical policy store and by tooling
that synthesizes tAPP scripts programmatically (e.g. the topology-aware
deployment generator in ``launch/serve.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import yaml

from repro_torch.core.tapp.ast import (
    Block,
    Invalidate,
    TagPolicy,
    TappScript,
    TopologyTolerance,
    WorkerRef,
    WorkerSet,
)


def _constraints_to_obj(item, obj: Dict[str, Any]) -> None:
    """Emit the optional constraint clauses of a block or worker item."""
    if item.invalidate is not None:
        obj["invalidate"] = _inv_to_text(item.invalidate)
    if item.affinity is not None:
        obj["affinity"] = list(item.affinity.functions)
    if item.anti_affinity is not None:
        obj["anti-affinity"] = list(item.anti_affinity.functions)


def script_to_obj(script: TappScript) -> List[Dict[str, Any]]:
    return [_tag_to_obj(tag) for tag in script.tags]


def script_to_yaml(script: TappScript) -> str:
    return yaml.safe_dump(script_to_obj(script), sort_keys=False)


def _tag_to_obj(tag: TagPolicy) -> Dict[str, Any]:
    body: List[Dict[str, Any]] = [_block_to_obj(b) for b in tag.blocks]
    if tag.strategy is not None:
        body.append({"strategy": tag.strategy.value})
    if tag.followup is not None:
        body.append({"followup": tag.followup.value})
    if tag.on_overload is not None:
        body.append({"on-overload": tag.on_overload.value})
    return {tag.tag: body}


def _block_to_obj(block: Block) -> Dict[str, Any]:
    obj: Dict[str, Any] = {}
    if block.controller is not None:
        obj["controller"] = block.controller.label
        if block.controller.topology_tolerance is not TopologyTolerance.ALL:
            obj["topology_tolerance"] = block.controller.topology_tolerance.value
    workers: List[Dict[str, Any]] = []
    for item in block.workers:
        if isinstance(item, WorkerRef):
            w: Dict[str, Any] = {"wrk": item.label}
            _constraints_to_obj(item, w)
            workers.append(w)
        elif isinstance(item, WorkerSet):
            w = {"set": item.label}
            if item.strategy is not None:
                w["strategy"] = item.strategy.value
            _constraints_to_obj(item, w)
            workers.append(w)
    obj["workers"] = workers
    if block.strategy is not None:
        obj["strategy"] = block.strategy.value
    if block.priority is not None:
        obj["priority"] = block.priority
    _constraints_to_obj(block, obj)
    return obj


def _inv_to_text(inv: Invalidate) -> str:
    return inv.describe()
