"""Dictionary checkpoints as one npz file per step — counterpart of
`hsc_tpu.learn.checkpoint`.

SURVEY.md §5 "Checkpoint / resume": the reference only pickles final
dictionaries (`hsc/dataset.py :: MultilevelDictionary.save`); the rebuild
checkpoints mid-run state — dictionary arrays, learner state (any NumPy
arrays) and the training step counter.

Same API, the same ``step_{step:08d}`` names and the same `latest_step`
semantics as the JAX package, which writes orbax checkpoint directories.
The port writes ``step_{step:08d}.npz`` with NumPy alone, so it cannot read
an orbax checkpoint, nor the JAX package a port one.  A write goes to a
temporary file that is renamed into place, so a crash mid-write never
leaves a torn checkpoint behind.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import CodecConfig
from ..dictionary import MultilevelDictionary


class DictionaryCheckpointer:
    """Save/restore a MultilevelDictionary (+ optional learner state dict of
    arrays) as one npz file per step."""

    def __init__(self, directory: str):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}.npz")

    def save(
        self,
        step: int,
        mld: MultilevelDictionary,
        learner_state: dict | None = None,
    ) -> None:
        arrays = {
            "config_json": np.frombuffer(mld.config.to_json().encode(), dtype=np.uint8).copy(),
            **{f"dicts/level_{k}": d for k, d in enumerate(mld.dicts)},
        }
        for name, value in (learner_state or {}).items():
            arrays[f"learner/{name}"] = np.asarray(value)
        path = self._path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith("step_") and name.endswith(".npz"):
                try:
                    steps.append(int(name[len("step_") : -len(".npz")]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(
        self, step: int | None = None
    ) -> tuple[int, MultilevelDictionary, dict] | None:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        with np.load(self._path(step)) as z:
            cfg = CodecConfig.from_json(bytes(bytearray(z["config_json"])).decode())
            dicts = [np.asarray(z[f"dicts/level_{k}"]) for k in range(cfg.num_levels)]
            prefix = "learner/"
            learner = {k[len(prefix) :]: z[k] for k in z.files if k.startswith(prefix)}
        return step, MultilevelDictionary(cfg, dicts), learner
