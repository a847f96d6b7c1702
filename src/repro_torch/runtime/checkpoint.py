"""Checkpoint manager (the reference's `runtime/checkpoint.py`): atomic,
async, keep-N.

  * **Atomicity** — a checkpoint is written to ``step_XXXXXXXX.tmp/`` and
    published by ``os.rename``; a crash mid-save never corrupts the latest.
  * **Async** — serialization runs on a worker thread
    (``save(..., blocking=False)``); the caller only waits for the copy to
    host memory, which is made on every device, so a later in-place step
    never reaches a snapshot that is still being written.
  * **Keep-N** — the oldest checkpoints are removed past ``keep_n``.

A state is a flat ``{name: tensor}`` dict (`train_step.state_tensors`).
Storage is one ``.npz`` of raw bytes per checkpoint, one array per tensor
(numpy has no bfloat16, so every tensor is saved as its bytes and bf16
comes back bit for bit), and a JSON manifest: step, names, dtypes, shapes
and the caller's ``extra``.  `restore` copies each tensor into the
matching tensor of ``like`` in place (on its device and dtype).  The
reference's reshard-on-load onto another mesh waits for ROADMAP A12.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bytes, as uint8 in fresh host memory (a CPU
    tensor's own storage is never handed out)."""
    flat = t.detach().reshape(-1)
    host = torch.empty(flat.shape, dtype=flat.dtype, device="cpu")
    host.copy_(flat)
    return host.view(torch.uint8).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # ---------------- save ----------------

    def save(self, step: int, tensors: dict[str, torch.Tensor], extra: dict | None = None,
             blocking: bool = True) -> None:
        """Snapshot ``tensors`` at ``step``.  The device-to-host copy happens
        here; the write on a worker thread unless ``blocking``."""
        self.wait()
        names = list(tensors)
        host = [_host_bytes(tensors[n]) for n in names]
        manifest = {"step": step, "names": names,
                    "dtypes": [str(tensors[n].dtype).removeprefix("torch.") for n in names],
                    "shapes": [list(tensors[n].shape) for n in names], "extra": extra or {}}

        def _write():
            tmp, final = self._path(step) + ".tmp", self._path(step)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "state.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                          # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, like: dict[str, torch.Tensor], step: int | None = None
                ) -> tuple[dict[str, torch.Tensor], dict]:
        """Copy checkpoint ``step`` (default: the latest) into the tensors of
        ``like``, in place, and return (``like``, the manifest).  Raises
        FileNotFoundError for a missing step and ValueError where the
        checkpoint's names, dtypes or shapes differ from ``like``'s."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.isdir(self._path(step)):
            raise FileNotFoundError(f"no checkpoint {'' if step is None else step} "
                                    f"in {self.dir}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["names"] != list(like):
            raise ValueError(f"checkpoint {step} holds other tensors than the state: "
                             f"{sorted(set(manifest['names']) ^ set(like))[:8]}")
        data = np.load(os.path.join(path, "state.npz"))
        for i, (name, t) in enumerate(like.items()):
            dt, shape = manifest["dtypes"][i], tuple(manifest["shapes"][i])
            if dt != str(t.dtype).removeprefix("torch.") or shape != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint {dt} {shape}, state {t.dtype} "
                                 f"{tuple(t.shape)}")
            raw = torch.from_numpy(np.array(data[f"leaf_{i}"]))
            t.copy_(raw.view(t.dtype).reshape(t.shape).to(t.device))
        return like, manifest
