"""Checkpoint I/O engines.

Port of ``deepspeed_tpu/runtime/checkpoint_engine.py`` (reference
``runtime/checkpoint_engine/``):

- ``TorchCheckpointEngine``: ``torch.save`` of a state that the caller has
  already copied to host memory, written to a temporary name and renamed,
  so a reader never sees half a file. The JAX package's msgpack and orbax
  engines have no counterpart: the card's machine has neither library.
- ``AsyncCheckpointEngine``: wraps an engine. ``save`` hands the write to one
  background thread and returns, so the disk time overlaps the next
  training steps; ``commit`` does not block; ``wait`` drains every pending
  write and raises the first failure; ``load`` waits first.
- ``create_checkpoint_engine``: from the ``checkpoint`` config section
  (``async_save`` adds the background thread).
"""

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import torch

logger = logging.getLogger(__name__)


class CheckpointEngine:
    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str) -> None:
        logger.info(f"[checkpoint] saving tag {tag}")

    def save(self, state: Any, path: str) -> None:
        raise NotImplementedError

    def save_text(self, text: str, path: str) -> None:
        """A small text file (``latest``), after the saves before it."""
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Any:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        return True

    def wait(self) -> None:
        """Block until every pending write is on disk."""
        return None

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)


def _atomic_write(path: str, write) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class TorchCheckpointEngine(CheckpointEngine):
    """``torch.save`` / ``torch.load`` of host states, written atomically."""

    def save(self, state: Any, path: str) -> None:
        _atomic_write(path, lambda tmp: torch.save(state, tmp))

    def save_text(self, text: str, path: str) -> None:
        def write(tmp):
            with open(tmp, "w") as f:
                f.write(text)

        _atomic_write(path, write)

    def load(self, path: str, map_location=None) -> Any:
        # files of this engine only: they hold the client state, which may be any picklable object
        return torch.load(path, map_location=map_location or "cpu", weights_only=False)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background writes (the reference's Nebula engine, JAX's
    ``AsyncCheckpointEngine``): the caller snapshots to host memory, ``save``
    queues the write on one worker thread (writes land in call order), and
    ``wait`` drains."""

    def __init__(self, config_params=None, base: Optional[CheckpointEngine] = None):
        super().__init__(config_params)
        self.base = base or TorchCheckpointEngine(config_params)
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-write")
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def _submit(self, fn, *args) -> None:
        fut = self._executor.submit(fn, *args)
        with self._lock:
            self._pending.append(fut)

    def save(self, state: Any, path: str) -> None:
        self._submit(self.base.save, state, path)

    def save_text(self, text: str, path: str) -> None:
        self._submit(self.base.save_text, text, path)

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        errors = []
        for fut in pending:
            try:
                fut.result()
            except Exception as e:  # drain every write before raising
                errors.append(e)
        self.base.wait()
        if errors:
            if len(errors) == 1:
                raise errors[0]
            raise RuntimeError(f"{len(errors)} checkpoint writes failed: {errors}")

    def commit(self, tag: str) -> bool:
        # deliberately non-blocking: the overlap with the next steps is the point; wait() makes it durable
        return True

    def load(self, path: str, map_location=None) -> Any:
        self.wait()
        return self.base.load(path, map_location=map_location)

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        self.base.makedirs(path, exist_ok=exist_ok)


def create_checkpoint_engine(config=None) -> CheckpointEngine:
    """From the ``checkpoint`` section: ``engine`` ``"torch"`` or ``"auto"``,
    ``async_save`` for the background thread."""
    ckpt = getattr(config, "checkpoint_config", None)
    name = str(getattr(ckpt, "engine", "auto")).lower()
    if name not in ("auto", "torch"):
        raise ValueError(f"unknown checkpoint engine {name!r}: the port writes with torch ('torch' or 'auto'); the "
                         "JAX package's msgpack and orbax engines are not ported")
    base = TorchCheckpointEngine(config)
    return AsyncCheckpointEngine(config, base=base) if getattr(ckpt, "async_save", False) else base
