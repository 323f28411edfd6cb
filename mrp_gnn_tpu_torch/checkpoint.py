"""Checkpoint / resume of the full train state (port of
``mrp_gnn_tpu/checkpoint.py``).

The JAX package saves its whole TrainState pytree with orbax. Here each
step's checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``, holding
what a resume needs, the fields of the JAX TrainState but the run key
(the port draws no random numbers after the model's init):

- ``model``: the model's ``state_dict``;
- ``optimizer``: the ``AdamW`` moments ``mu`` and ``nu`` and its ``count``
  (which drives the learning-rate schedule);
- ``step``, ``best_rmse`` and ``best_step``.

Every file is written under a temporary name in the same directory and
then renamed (``os.replace``), so a reader never sees a partial file. The
newest ``max_to_keep`` checkpoints are kept. A serialized data-iterator
state rides beside a checkpoint as ``data_state_<step>.json``, under the
JAX package's name. Restoring loads onto the device of the state it
restores into, so a checkpoint written on the card loads in a CPU run.
Orbax checkpoints of the JAX package cannot be read here.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, then rename it
    to ``path``; the temporary file goes if ``write`` fails."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step}.pt")

    def _data_path(self, step: int) -> str:
        return os.path.join(self._dir, f"data_state_{step}.json")

    def _steps(self) -> list:
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                                   os.listdir(self._dir)) if m)

    def save(self, step: int, state,
             data_state: Optional[str] = None) -> None:
        """Write ``state`` (a ``train.TrainState``) as step ``step``, with
        ``data_state`` beside it, then drop all but the newest
        ``max_to_keep`` checkpoints."""
        os.makedirs(self._dir, exist_ok=True)
        opt = state.optimizer
        payload = {"step": int(state.step),
                   "best_rmse": float(state.best_rmse),
                   "best_step": int(state.best_step),
                   "model": state.model.state_dict(),
                   "optimizer": {"mu": opt.mu, "nu": opt.nu,
                                 "count": int(opt.count)}}
        if data_state is not None:
            # Written first: a checkpoint is never visible without its
            # data state.
            _atomic_write(self._data_path(step),
                          lambda f: f.write(data_state.encode()))
        _atomic_write(self._ckpt_path(step), lambda f: torch.save(payload, f))
        for old in self._steps()[:-self._max_to_keep]:
            for path in (self._ckpt_path(old), self._data_path(old)):
                if os.path.exists(path):
                    os.remove(path)

    def latest_data_state(self) -> Optional[str]:
        """Serialized data-iterator state saved with the newest step, if any."""
        step = self.latest_step
        if step is None or not os.path.exists(self._data_path(step)):
            return None
        with open(self._data_path(step)) as f:
            return f.read()

    def restore_latest(self, state):
        """Load the newest checkpoint into ``state`` (a ``train.TrainState``:
        model, optimizer, step and best tracking, in place, on the device of
        the state's parameters) and return it; None if no checkpoint
        exists."""
        step = self.latest_step
        if step is None:
            return None
        device = next(state.model.parameters()).device
        payload = torch.load(self._ckpt_path(step), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        opt, saved = state.optimizer, payload["optimizer"]
        if len(saved["mu"]) != len(opt.mu):
            raise ValueError(f"{self._ckpt_path(step)} holds moments for "
                             f"{len(saved['mu'])} parameters, the optimizer "
                             f"has {len(opt.mu)}")
        with torch.no_grad():
            for dst, src in zip(opt.mu + opt.nu, saved["mu"] + saved["nu"]):
                dst.copy_(src)
        opt.count = saved["count"]
        state.step = payload["step"]
        state.best_rmse = payload["best_rmse"]
        state.best_step = payload["best_step"]
        return state

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Saves are synchronous; nothing is left to wait for."""
