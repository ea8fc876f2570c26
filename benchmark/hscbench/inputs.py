"""A cell's inputs, made from the run's seed: the dictionaries, the signal
pool, and the restore cell's container.

The dictionaries come from the reference's frozen generator (host NumPy;
they are small).  Signals follow the model of the port's
`SignalGenerator(rates=...)`: at every valid placement of every raw atom of
every level an event occurs with probability `rate`, with an amplitude
uniform in `amplitude_range` and a random sign, and the block is the
overlap-add of the events' signal-space representations.  The pool is
drawn on the device with a `torch.Generator` in a few large calls (one
uniform draw per placement decides the event, its sign and its amplitude)
and copied to the host once: the same model, not the same bytes as the
port's per-event Python loop, which takes minutes for a pool.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import container
from reference.config import CodecConfig
from reference.dictionary import MultilevelDictionary


def derived_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *tags]).generate_state(1, np.uint64)[0] >> 1)


def codec_config(config: dict) -> CodecConfig:
    c = dict(config["codec"])
    for key in ("counts", "scales", "num_coefs"):
        c[key] = tuple(c[key])
    return CodecConfig(**c)


def make_dictionary(config: dict, seed: int) -> MultilevelDictionary:
    cfg = codec_config(config)
    return MultilevelDictionary.generate(cfg, seed=derived_seed(seed, 1))


def signal_pool(mld: MultilevelDictionary, n_blocks: int, signals: dict, seed: int, device,
                chunk: int = 256) -> np.ndarray:
    """``[n_blocks, block_size]`` float32 signals on the host."""
    cfg = mld.config
    n = cfg.block_size
    rate = float(signals["rates"])
    lo, hi = (float(v) for v in signals["amplitude_range"])
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 2))
    reps = [torch.as_tensor(mld.representations(k)[: cfg.counts[k]], device=device) for k in range(cfg.num_levels)]
    out = np.empty((n_blocks, n), np.float32)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for b0 in range(0, n_blocks, chunk):
            b = min(chunk, n_blocks - b0)
            x = torch.zeros((b, 1, n), dtype=torch.float32, device=device)
            for k, rep in enumerate(reps):
                kk, scale = rep.shape
                u = torch.rand((b, kk, n - scale + 1), generator=gen, device=device)
                v = u / rate  # uniform in [0, 1) where an event occurs
                amp = torch.where(v < 0.5, -(lo + (hi - lo) * 2 * v), lo + (hi - lo) * (2 * v - 1))
                m = torch.where(u < rate, amp, torch.zeros((), device=device))
                # overlap-add of rep[a] at every event: a correlation with the
                # flipped representations over the zero-padded map
                x += F.conv1d(F.pad(m, (scale - 1, scale - 1)), rep.flip(-1)[None])
                del u, v, amp, m
            out[b0:b0 + b] = x[:, 0].cpu().numpy()
    return out


def container_records(cfg: CodecConfig, n_blocks: int, seed: int) -> np.ndarray:
    """``[n_blocks, bytes]`` block records of a one-level container with
    ``num_coefs`` events a block: positions and atoms uniform, codes of
    both signs with magnitudes falling off from the quantizer's top, and a
    per-block scale near a flagship block's."""
    rng = np.random.default_rng(derived_seed(seed, 3))
    m = cfg.num_coefs[0]
    npos = cfg.num_positions(0)
    maxcode = cfg.amp_maxcode
    positions = rng.integers(0, npos, (n_blocks, m))
    atoms = rng.integers(0, cfg.counts[0], (n_blocks, m))
    mags = np.maximum(1, np.floor(maxcode * rng.random((n_blocks, m)) ** 3)).astype(np.int64)
    codes = np.where(rng.random((n_blocks, m)) < 0.5, -mags, mags)
    scales = (rng.uniform(4.0, 8.0, n_blocks) / maxcode).astype(np.float32)
    parts = [
        container.records_same_count(cfg, 0, positions[i:i + 512], atoms[i:i + 512], codes[i:i + 512],
                                     scales[i:i + 512])
        for i in range(0, n_blocks, 512)
    ]
    return np.concatenate(parts)
