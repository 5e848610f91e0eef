"""Log persistence and sweep checkpoint / resume (the JAX package's
``utils/record.py``).

- :func:`save_log` / :func:`load_log`: a tree of tensors (closed-loop
  logs, reference tables) as compressed npz under the JAX package's key
  strings, with an optional ``.meta.json`` beside it; either package reads
  the other's files.
- :class:`SweepCheckpoint`: a sweep's state (per-scenario carries, plant
  states, running sums), one ``torch.save`` file per rank per step,
  ``latest``-resume; ``torch.load(weights_only=True)`` reads it back.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .tree import tree_items, tree_map


def save_log(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Save a tree of tensors as compressed npz (+ json meta)."""
    arrays = {key: leaf.detach().cpu().numpy() for key, leaf in tree_items(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)


def load_log(path: str) -> Dict[str, np.ndarray]:
    """A saved log as {path key: array}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_STEP_DIR = re.compile(r"^step_(\d+)$")


class SweepCheckpoint:
    """Checkpoint / resume of a sweep's state over ranks.

    ``save(step, state)`` writes this rank's ``step_<k>/rank<r>.pt`` (to a
    temporary name first, then renamed, so that a killed save leaves no
    partial file under the final name) and keeps this rank's ``keep``
    newest steps (the caller holds the ranks within one step of each other,
    so that no rank writes a step that another prunes). ``latest_step`` is
    the newest step that every one of the ``world_size`` ranks has written;
    ``restore`` reads this rank's file of it into the structure and devices
    of a template state. ``run`` is the resumable chunk loop of a sweep."""

    def __init__(self, directory: str, keep: int = 3, rank: int = 0, world_size: int = 1):
        self._dir = os.path.abspath(directory)
        self.keep, self.rank, self.world_size = keep, rank, world_size
        os.makedirs(self._dir, exist_ok=True)

    def _file(self, step: int, rank: int) -> str:
        return os.path.join(self._dir, f"step_{step}", f"rank{rank}.pt")

    def _steps(self, ranks) -> list:
        steps = []
        for name in os.listdir(self._dir):
            m = _STEP_DIR.match(name)
            if m and all(os.path.exists(self._file(int(m.group(1)), r)) for r in ranks):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state) -> Tuple[int, float]:
        """Write this rank's state at ``step``; returns (the file's bytes,
        the seconds the save took)."""
        t0 = time.perf_counter()
        path = self._file(step, self.rank)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(dict(tree_items(state)), tmp)
        os.replace(tmp, path)
        for old in self._steps([self.rank])[:-self.keep]:
            os.remove(self._file(old, self.rank))
            try:    # the last rank out removes the step's directory
                os.rmdir(os.path.dirname(self._file(old, self.rank)))
            except OSError:
                pass
        return os.path.getsize(path), time.perf_counter() - t0

    def latest_step(self) -> Optional[int]:
        steps = self._steps(range(self.world_size))
        return steps[-1] if steps else None

    def restore(self, template):
        """(step, state) of the latest step in the shape of ``template``,
        each tensor on its template's device; (None, None) if none."""
        step = self.latest_step()
        if step is None:
            return None, None
        saved = torch.load(self._file(step, self.rank), weights_only=True, map_location="cpu")
        keys = iter(key for key, _ in tree_items(template))
        state = tree_map(lambda t: saved[next(keys)].to(t.device), template)
        return step, state

    def run(self, state, chunk_fn: Callable, T: int, save_every: int,
            after_save: Optional[Callable[[], None]] = None):
        """``T`` steps of a sweep in chunks of ``save_every``: resume from the
        latest complete step (``state`` is the step-0 state and the
        template), then ``state = chunk_fn(state)`` and a save per chunk,
        ``after_save()`` after each save. Returns (the final state, the
        steps run by this call)."""
        if T % save_every != 0:
            raise ValueError(f"T={T} must be a multiple of save_every={save_every}")
        step = 0
        if self.latest_step() is not None:
            step, state = self.restore(state)
        step0 = step
        while step < T:
            state = chunk_fn(state)
            step += save_every
            self.save(step, state)
            if after_save is not None:
                after_save()
        return state, step - step0
