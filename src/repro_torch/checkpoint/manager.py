"""Fault-tolerant checkpointing of the port's training state.

The reference's ``repro.checkpoint.manager`` on torch tensors:

* every tensor is saved as its logical value in a per-leaf ``.npy`` file,
  with a JSON manifest of leaf names, dtypes, shapes and the step (bf16
  leaves are stored as fp32 and cast back on restore);
* writes go to ``step_N.tmp/`` and are renamed to ``step_N`` — a crash
  mid-write never corrupts the latest checkpoint;
* ``save(..., blocking=False)`` copies the tensors to the host, then hands
  them to a writer thread so the train loop continues;
* keep-last-k (+ optional keep-every) retention; ``latest_step`` and
  ``restore`` pick up after preemption;
* a DTensor leaf is saved whole (its ``full_tensor``), and ``restore(...,
  shardings=)`` places each leaf on a mesh again — on any mesh and
  placements: the elastic re-shard.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "\x1d"


def _named_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                  ) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(_SEP.join(prefix), tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    return [x for k, v in items for x in _named_leaves(v, prefix + (str(k),))]


def _rebuild(like: Any, leaves: Dict[str, torch.Tensor],
             prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(like, torch.Tensor):
        return leaves[_SEP.join(prefix)]
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves, prefix + (f,))
                            for f, v in zip(like._fields, like)))
    return type(like)(_rebuild(v, leaves, prefix + (str(i),))
                      for i, v in enumerate(like))


def _is_sharding(x: Any) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and hasattr(x[0], "mesh_dim_names"))


def _named_shardings(tree: Any, prefix: Tuple[str, ...] = ()
                     ) -> Dict[str, Any]:
    """Leaf name → (mesh, placements) of a shardings tree shaped as the
    restored tree."""
    if _is_sharding(tree):
        return {_SEP.join(prefix): tree}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_named_shardings(v, prefix + (str(k),)))
    return out


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if hasattr(x, "full_tensor"):          # a DTensor: its whole value
        x = x.full_tensor()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3,
                 keep_every: Optional[int] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._thread: Optional[threading.Thread] = None

    # -- writing -------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        named = _named_leaves(tree)
        # device -> host before handing to the writer thread
        host = [(n, str(x.dtype).removeprefix("torch."), _to_numpy(x))
                for n, x in named]
        self.wait()

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": [], "extra": extra or {}}
            for i, (name, dtype, arr) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(tmp / fn, arr)
                manifest["leaves"].append({"name": name, "file": fn,
                                           "dtype": dtype,
                                           "shape": list(arr.shape)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- reading -------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``like``; each leaf takes the
        device and dtype of the matching leaf of ``like``.  ``shardings``
        (a tree shaped as ``like`` of ``(mesh, placements)`` leaves, e.g.
        from :func:`repro_torch.parallel.sharding.placements`) places each
        restored leaf on its mesh with ``distribute_tensor``: the elastic
        re-shard, onto whatever mesh the run now has."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_name = {m["name"]: m for m in manifest["leaves"]}
        leaves = {}
        for name, leaf in _named_leaves(like):
            arr = np.load(d / by_name[name]["file"])
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            leaves[name] = torch.from_numpy(arr).to(device=leaf.device,
                                                    dtype=leaf.dtype)
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            for name, (mesh, pl) in _named_shardings(shardings).items():
                leaves[name] = distribute_tensor(leaves[name], mesh, pl)
        return _rebuild(like, leaves), step, manifest.get("extra", {})
