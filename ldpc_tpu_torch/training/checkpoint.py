"""Step-numbered training checkpoints with retention (counterpart of
``ldpc_tpu.training.checkpoint``, where orbax writes them).

Each save is ``torch.save`` of ``{"params", "opt_state", "history"}`` into
``<directory>/<step>/checkpoint.pt``, written under a temporary name and
moved into place with ``os.replace``: a process killed mid-write leaves every
earlier checkpoint whole and no half-written one that :meth:`latest_step`
would pick.  The last ``max_to_keep`` steps are kept.  Payloads hold tensors
and plain Python values only, so they load with ``weights_only=True``.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any

import torch

_FILE = "checkpoint.pt"


class CheckpointManager:
    """Save, list and restore step-numbered checkpoints under ``directory``."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def all_steps(self) -> list[int]:
        """Steps with a complete checkpoint, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _FILE).is_file())

    def save(self, step: int, params: Any, opt_state: Any = None,
             history: dict | None = None) -> None:
        payload = {"params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if history is not None:
            payload["history"] = history
        step_dir = self.directory / str(int(step))
        step_dir.mkdir(exist_ok=True)
        tmp = step_dir / f"{_FILE}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, step_dir / _FILE)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict[str, Any]:
        """The payload of ``step`` (default: the latest), tensors on the CPU."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.directory / str(step) / _FILE
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint of step {step} under {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Nothing stays open between saves; kept for the JAX package's API."""
