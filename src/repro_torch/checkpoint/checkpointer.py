"""Atomic, async checkpointing (port of ``repro/checkpoint/checkpointer.py``).

The on-disk layout is the reference's, so a checkpoint written by the
JAX ``Checkpointer`` restores here::

    <dir>/step_000000123/
        manifest.json            # leaf names, files, shapes, dtypes, extra
        arrays/<leaf-id>.npy     # one file per leaf, in flatten order
    <dir>/step_000000123.COMMITTED  # atomicity marker (written last)

Leaf names are the reference's: the path of keys joined by ``/``, dict
keys sorted as ``jax.tree_util`` flattens them, NamedTuple fields by
name (``params/embed/table``, ``opt/step``, ``opt/m/...``), ``None``
dropped. A checkpoint is visible only after its marker; ``save(...,
blocking=False)`` copies the tensors to the host, then writes on a
background thread; ``keep_last`` bounds disk use.

bfloat16 has no numpy type here (``ml_dtypes`` is not assumed), so a
bfloat16 leaf is written as its 16-bit pattern (``uint16``) with dtype
``"bfloat16"`` in the manifest, and read back through the manifest's
dtype. The reference writes bfloat16 as ``'<V2'`` (``np.save`` of an
``ml_dtypes`` array), which this module reads too; the reference itself
cannot restore such a leaf (``jnp.asarray`` rejects ``|V2``).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_names(tree: Any, leaf_type=None) -> List[Tuple[str, Any]]:
    """(name, leaf) in ``jax.tree_util``'s flatten order; a ``leaf_type``
    instance (a named tuple such as ``NamedSharding``) is a leaf."""
    out: List[Tuple[str, Any]] = []

    def visit(path, node):
        if node is None:
            return
        if leaf_type is not None and isinstance(node, leaf_type):
            out.append(("/".join(path), node))
        elif _is_namedtuple(node):
            for field in node._fields:
                visit(path + (field,), getattr(node, field))
        elif isinstance(node, dict):
            for key in sorted(node):
                visit(path + (str(key),), node[key])
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                visit(path + (str(i),), value)
        else:
            out.append(("/".join(path), node))

    visit((), tree)
    return out


def _rebuild(like: Any, leaf_fn, path=()) -> Any:
    """``like``'s structure with each leaf replaced by ``leaf_fn(name, leaf)``."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaf_fn, path + (f,))
                            for f in like._fields))
    if isinstance(like, dict):
        return {key: _rebuild(value, leaf_fn, path + (str(key),)) for key, value in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaf_fn, path + (str(i),)) for i, v in enumerate(like))
    return leaf_fn("/".join(path), like)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype): a copy, so later in-place writes
    to ``leaf`` (a CPU tensor shares its memory with ``.numpy()``) cannot
    reach an async save."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):  # the full tensor: a checkpoint knows no mesh
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class Checkpointer:
    def __init__(self, directory: str, *, keep_last: int = 3) -> None:
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- save ---------------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[Dict] = None) -> None:
        """Snapshot to host, then write (optionally on a background thread).

        A DTensor leaf is gathered whole, a collective every rank of its
        mesh takes part in; of several ranks only rank 0 writes."""
        import torch.distributed as dist

        self.wait()  # one async save in flight at a time
        host_leaves = [(name, *_to_host(leaf)) for name, leaf in _flatten_with_names(tree)]
        if dist.is_initialized() and dist.get_rank() != 0:
            return

        def write() -> None:
            final = self.dir / f"step_{step:09d}"
            tmp = self.dir / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            (tmp / "arrays").mkdir(parents=True)
            manifest = {
                "step": step,
                "treedef": "named leaves (repro_torch)",
                "leaves": [],
                "extra": extra or {},
            }
            for idx, (name, arr, dtype) in enumerate(host_leaves):
                fname = f"{idx:05d}.npy"
                np.save(tmp / "arrays" / fname, arr)
                manifest["leaves"].append(
                    {"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype}
                )
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            # Commit marker written last → crash-safe visibility.
            (self.dir / f"step_{step:09d}.COMMITTED").touch()
            self._gc()

        if blocking:
            write()
        else:
            def background() -> None:
                try:
                    write()
                except Exception as e:  # re-raised by wait() in the caller's thread
                    self._error = e

            self._pending = threading.Thread(target=background, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        """Join the save in flight; re-raise its error, if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # -- restore -------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        for marker in self.dir.glob("step_*.COMMITTED"):
            m = re.match(r"step_(\d+)\.COMMITTED", marker.name)
            if m and (self.dir / f"step_{int(m.group(1)):09d}").exists():
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, like: Any, *, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``like``, each leaf onto the device
        of ``like``'s leaf of the same name (the CPU for a non-tensor leaf).

        Elastic restore: with ``shardings`` (a tree of ``NamedSharding``
        matching ``like``) each leaf is placed on its sharding, on whatever
        mesh is current; a DTensor leaf of ``like`` without ``shardings``
        keeps its mesh and placements. Returns (tree, step, extra)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self.dir / f"step_{step:09d}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves = {info["name"]: info for info in manifest["leaves"]}

        names = [name for name, _ in _flatten_with_names(like)]
        missing = [n for n in names if n not in leaves]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}…")

        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch.sharding.specs import NamedSharding, distribute

        by_name = {}
        if shardings is not None:
            for name, sh in _flatten_with_names(shardings, leaf_type=NamedSharding):
                by_name[name] = sh

        def load(name, leaf):
            info = leaves[name]
            tensor = _from_host(np.load(path / "arrays" / info["file"]), info["dtype"])
            if name in by_name:
                return distribute(tensor.to(by_name[name].mesh.device_type), by_name[name])
            if isinstance(leaf, DTensor):
                return distribute_tensor(tensor.to(leaf.device), leaf.device_mesh,
                                         leaf.placements, src_data_rank=None)
            device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            return tensor.to(device)

        return _rebuild(like, load), step, manifest.get("extra", {})

    # -- gc -------------------------------------------------------------------------

    def _gc(self) -> None:
        steps = sorted(
            int(re.match(r"step_(\d+)\.COMMITTED", m.name).group(1))
            for m in self.dir.glob("step_*.COMMITTED")
        )
        for old in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{old:09d}", ignore_errors=True)
            (self.dir / f"step_{old:09d}.COMMITTED").unlink(missing_ok=True)
