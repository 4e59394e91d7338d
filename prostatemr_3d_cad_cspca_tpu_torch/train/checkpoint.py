"""Full training-state checkpoints (parameters + optimizer state + step +
model config), the port's counterpart of the JAX package's
``train/checkpoint.py``.

The JAX package writes through orbax, which is JAX-only; the port writes
one ``torch.save`` file a step, ``<directory>/<step>.pt``, holding
``params`` (the module's parameters by name), ``opt_state`` (the
optimizer's state: ``count`` and its moment dicts), ``step`` and
``config``, plus ``model_config.json`` once. The directory is not orbax's
and the port reads no orbax checkpoint.

The rules are orbax's (``CheckpointManagerOptions`` with ``max_to_keep``
and ``save_interval_steps``): a step is saved when it is past the latest
saved step and a multiple of the interval, or when no checkpoint exists
yet; the ``max_to_keep`` latest steps are kept (None keeps all).

Writes are atomic and asynchronous, as orbax's are: ``save`` snapshots the
state to host memory on the calling thread (on a card: copies into pinned
buffers enqueued on the current stream, so the steps enqueued after it
cannot change what is saved), and a worker thread waits for the copies,
writes ``<step>.pt.tmp`` and renames it into place; older steps are
deleted only after that. ``wait`` joins the worker and raises its error.
A crash before the rename leaves the previous checkpoints readable.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _snapshot(tree):
    """``tree`` with each tensor replaced by a host copy: the tensors of one
    dtype and device are concatenated into one buffer (on a card: one
    device concatenation, then one copy into pinned memory enqueued on the
    current stream) and come back as views of it, so a save moves each
    dtype's state in one transfer and stores one storage."""
    leaves = []
    _tree_map(leaves.append, tree)
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in leaves:
        groups.setdefault((t.dtype, t.device), []).append(t)
    views = {}  # by the id of a tensor of the tree, which the tree keeps alive
    for (dtype, device), ts in groups.items():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if device.type == "cuda":
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
        else:
            host = flat
        offset = 0
        for t in ts:
            views[id(t)] = host[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
    return _tree_map(lambda t: views[id(t)], tree)


class CheckpointManager:
    """Full-state checkpoints of a training run under ``directory``."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = int(save_interval_steps)
        self._steps: List[int] = self._scan()
        self._thread: Optional[threading.Thread] = None
        self._dropping: List[int] = []  # steps the write in flight deletes once it lands
        self._error: Optional[BaseException] = None
        self.write_seconds: Optional[float] = None  # the last write, on the worker

    def _scan(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return list(self._steps)

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def save(self, step: int, state, config: Optional[Dict[str, Any]] = None) -> bool:
        """Snapshot ``state`` (a ``trainer.TrainState``) and write it as
        ``step`` on the worker thread; returns whether it saves."""
        step = int(step)
        if not self.should_save(step):
            return False
        self.wait()
        host = _snapshot({"params": dict(state.params), "opt_state": state.opt_state})
        payload = {**host, "step": int(state.step), "config": config}
        done = None
        if torch.cuda.is_available() and any(
                p.device.type == "cuda" for p in state.params.values()):
            done = torch.cuda.Event()
            done.record()
        self._steps.append(step)
        self._dropping = (self._steps[:-self.max_to_keep] if self.max_to_keep is not None
                          and len(self._steps) > self.max_to_keep else [])
        self._thread = threading.Thread(target=self._write,
                                        args=(step, payload, done, list(self._dropping)),
                                        daemon=True)
        self._thread.start()
        if config is not None:
            cfg_path = os.path.join(self.directory, "model_config.json")
            if not os.path.exists(cfg_path):
                tmp = cfg_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(config, f, default=str)
                os.replace(tmp, cfg_path)
        return True

    def _write(self, step, payload, done, drop):
        try:
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            path = self._path(step)
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in drop:
                if os.path.exists(self._path(old)):
                    os.remove(self._path(old))
            self.write_seconds = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001  (raised by wait())
            self._error = e

    def restore(self, state_like=None, device="cuda") -> Tuple[Any, int]:
        """Restore the latest checkpoint: into ``state_like`` (its module's
        parameters are overwritten in place, the optimizer state and step
        come from the file, all on the module's device) -> (state, step);
        without one, -> (payload dict on ``device``, step). Raises if no
        checkpoint exists."""
        if state_like is not None:
            device = next(iter(state_like.params.values())).device
        device = resolve_device(device)
        self.wait()
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        if state_like is None:
            return payload, step
        params = state_like.params
        if set(payload["params"]) != set(params):
            raise ValueError(f"checkpoint {self._path(step)} holds other parameters than "
                             "the model's")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(payload["params"][k])
        state = type(state_like)(module=state_like.module, opt_state=payload["opt_state"],
                                 step=int(payload["step"]))
        return state, step

    def wait(self):
        """Join the write in flight; raise its error (the steps are then
        read again from the directory)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        dropped, self._dropping = self._dropping, []
        if self._error is not None:
            err, self._error = self._error, None
            self._steps = self._scan()
            raise err
        self._steps = [s for s in self._steps if s not in dropped]

    def close(self):
        self.wait()

    @staticmethod
    def load_config(directory: str) -> Optional[Dict[str, Any]]:
        cfg_path = os.path.join(directory, "model_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                return json.load(f)
        return None
