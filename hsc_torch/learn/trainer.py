"""Multilevel training driver: learn level-k filters, encode the corpus at
level k, feed coefficient maps to level k+1 — counterpart of
`hsc_tpu.learn.trainer`.

Reference parity (SURVEY.md §3.5 "Multilevel training driver"): the reference
scripts alternate `ConvolutionalDictionaryLearner.train` and MP encoding per
level.  Here each level's encode is the port's batched
`models.ConvolutionalMatchingPursuit` (the greedy-loop kernel on a card) with
the JAX trainer's arguments, quirks included: one selection per sweep and
the f32 init at every level, whatever the config's `num_select` and
`hier_init`.  The level hand-off is `ops.encode.feature_map`, copied to the
host as the JAX trainer copies its map.  The per-level resume journal
(``trainer_state.npz``) is the JAX package's, key for key, so either
package resumes from the other's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..config import CodecConfig
from ..device import canonical_device
from ..dictionary import MultilevelDictionary
from ..models.coder import ConvolutionalMatchingPursuit
from ..ops.encode import feature_map
from .kmeans import ConvolutionalDictionaryLearner


@dataclasses.dataclass
class TrainerState:
    """Journal of completed levels (resume unit = one level)."""

    level: int
    dicts: list[np.ndarray]


class MultilevelTrainer:
    """Learns a full MultilevelDictionary from raw signal blocks on `device`;
    with a `mesh` each level's k-means statistics are sharded over 'data'
    (the level encodes stay unsharded, as in the JAX package)."""

    def __init__(
        self,
        config: CodecConfig,
        *,
        algorithm: str = "kmean",
        num_windows: int = 4096,
        iterations: int = 20,
        seed: int = 0,
        checkpoint_dir: str | None = None,
        mesh=None,
        device,
    ):
        self.config = config
        self.algorithm = algorithm
        self.num_windows = num_windows
        self.iterations = iterations
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.device = canonical_device(device)
        if mesh is not None:
            from ..parallel.mesh import check_mesh_device

            check_mesh_device(mesh, self.device, "MultilevelTrainer")
        self.mesh = mesh  # shard each level's k-means statistics over 'data'

    def _learn_level(self, level: int, seqs: np.ndarray) -> np.ndarray:
        cfg = self.config
        learner = ConvolutionalDictionaryLearner(
            cfg.counts[level],
            cfg.window_sizes[level],
            cfg.channels[level],
            algorithm=self.algorithm,
            num_windows=self.num_windows,
            iterations=self.iterations,
            seed=self.seed + level,
            device=self.device,
        )
        return learner.train(seqs, mesh=self.mesh)

    def _encode_level(
        self, level: int, dicts: list[np.ndarray], seqs: np.ndarray
    ) -> np.ndarray:
        """Encode every block at `level` with the partial dictionary and
        return the batched quantized coefficient maps for level+1."""
        cfg = self.config
        mld = MultilevelDictionary(
            _partial_config(cfg, level + 1),
            dicts[: level + 1],
        )
        mp = ConvolutionalMatchingPursuit(
            mld.augmented(level),
            mld.gram(level),
            num_coefs=cfg.num_coefs[level],
            amp_bits=cfg.amp_bits,
            tolerance_snr=cfg.tolerance_snr,
            singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
            n_raw=cfg.counts[level],
            device=self.device,
        )
        enc = mp.compute_coefficients_batch(seqs)
        fmap = feature_map(enc, npos=cfg.num_positions(level), k=mld.num_atoms(level))
        return fmap.cpu().numpy()

    def train(self, blocks: np.ndarray) -> MultilevelDictionary:
        """`blocks [B, block_size]` -> learned MultilevelDictionary.

        Level-by-level (SURVEY.md §3.5): each finished level is checkpointed;
        `train` resumes from the last completed level if a checkpoint exists.
        """
        cfg = self.config
        state = self._restore() or TrainerState(level=0, dicts=[])
        seqs = np.asarray(blocks, dtype=np.float32)
        if seqs.ndim == 2:
            seqs = seqs[:, :, None]
        # replay encodes for already-learned levels to rebuild the input seqs
        for level in range(state.level):
            seqs = self._encode_level(level, state.dicts, seqs)
        for level in range(state.level, cfg.num_levels):
            d = self._learn_level(level, seqs)
            state.dicts.append(d)
            state.level = level + 1
            self._save(state)
            if level + 1 < cfg.num_levels:
                seqs = self._encode_level(level, state.dicts, seqs)
        return MultilevelDictionary(cfg, state.dicts)

    # -- checkpointing ------------------------------------------------------

    def _ckpt_path(self):
        return os.path.join(self.checkpoint_dir, "trainer_state.npz")

    def _save(self, state: TrainerState) -> None:
        if self.checkpoint_dir is None:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        arrays = {f"dict_{k}": d for k, d in enumerate(state.dicts)}
        np.savez(self._ckpt_path(), level=np.int64(state.level), **arrays)

    def _restore(self) -> TrainerState | None:
        if self.checkpoint_dir is None or not os.path.exists(self._ckpt_path()):
            return None
        with np.load(self._ckpt_path()) as z:
            level = int(z["level"])
            dicts = [z[f"dict_{k}"] for k in range(level)]
        return TrainerState(level=level, dicts=dicts)


def _partial_config(cfg: CodecConfig, num_levels: int) -> CodecConfig:
    return dataclasses.replace(
        cfg,
        counts=cfg.counts[:num_levels],
        scales=cfg.scales[:num_levels],
        num_coefs=cfg.num_coefs[:num_levels],
    )
