"""Step checkpointing for long training runs.

Port of ``predictionio_tpu/workflow/checkpoint.py`` (which wraps orbax):
the same API, saving a dict of tensors a step with ``torch.save``.  Long
ALS runs checkpoint their factors every K iterations and resume from the
latest step (the reference's PredictionIO reruns a failed job from
scratch).

Each step is one file, ``<directory>/step_<step>.pt``, written to a
temporary name, flushed to disk and renamed into place, so a step that
exists was written whole; a file torn afterwards (a truncated copy, a
disk fault) is met by :meth:`StepCheckpointer.restore`'s fallback to the
step before it.
"""

from __future__ import annotations

import logging
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["StepCheckpointer"]

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class StepCheckpointer:
    """Saves dicts of tensors keyed by integer step; restores the latest
    (or a given) step.  ``keep`` newest steps stay on disk."""

    def __init__(self, directory: str | Path, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.last_restored_step: Optional[int] = None

    def path(self, step: int) -> Path:
        """The file that holds ``step``."""
        return self.directory / f"step_{int(step):08d}.pt"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.directory.iterdir():
            m = _STEP_FILE.match(p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, tree: Any, wait: bool = True) -> None:
        """Write ``tree`` (a dict of tensors or arrays) as ``step``, then
        drop all but the ``keep`` newest steps.  ``wait`` is the
        reference's flag; the write is always synchronous."""
        host = {k: torch.as_tensor(v).detach().cpu() for k, v in tree.items()}
        fd, tmp = tempfile.mkstemp(prefix=".step-", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(step))
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
        for old in self.all_steps()[:-self.keep]:
            self.path(old).unlink(missing_ok=True)
        logger.info("checkpoint step %d -> %s", step, self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Restore ``step`` (default latest).  ``like`` — a dict of
        tensors — puts each restored tensor on its entry's device and
        dtype.

        When no explicit ``step`` was requested and the newest step
        turns out torn, restore falls back through older steps instead
        of failing the whole resume; an explicitly requested step never
        falls back.  The step actually restored is recorded as
        ``last_restored_step``."""
        explicit = step is not None
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        candidates = [step] if explicit else sorted(
            (s for s in self.all_steps() if s <= step), reverse=True
        ) or [step]
        last_err: Optional[BaseException] = None
        for i, s in enumerate(candidates):
            try:
                out = self._restore_step(s, like)
            except Exception as e:
                last_err = e
                if i + 1 < len(candidates):
                    logger.warning(
                        "checkpoint step %d is unreadable (%s: %s); "
                        "falling back to step %d",
                        s, type(e).__name__, e, candidates[i + 1],
                    )
                continue
            self.last_restored_step = s
            return out
        raise last_err

    def _restore_step(self, step: int, like: Any = None) -> Any:
        tree = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        if like is None:
            return tree
        out = {}
        for k, v in tree.items():
            ref = like.get(k)
            if ref is not None:
                ref = torch.as_tensor(ref)
                v = v.to(device=ref.device, dtype=ref.dtype)
            out[k] = v
        return out

    def close(self) -> None:
        """Nothing stays open between calls (the reference closes its
        orbax manager here)."""
