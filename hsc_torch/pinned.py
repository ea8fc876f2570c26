"""Pinned-oracle helpers: the NumPy oracle (`oracle.mp.mp_encode`) run with
the port's own initial correlation injected (``scores0`` / ``energy0``).

The init is the one stage whose float order is the backend's choice, so a
greedy loop is held bitwise against the oracle only given the same init
(README "Determinism contract").  These are the counterparts of the JAX
package's test helpers (tests/pinned.py) for a device the port runs on:
the random-geometry fuzz (scripts/torch_fuzz_parity.py, which chip_smoke.py
runs as its phase 15) and the CPU gate scripts/torch_smoke.py hold the port
to this one definition.  chip_smoke.py's phases 3 and 9 inject other inits
(the init of a 64-block batch; the oracle's own int8 scores) and call `mp_encode`
themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from .oracle.mp import feature_map_int_from_events, mp_encode
from .ops.encode import encode_init_batched, encode_init_int_batched
from .params import int8_bank_tables


def device_init(x2d: np.ndarray, bank: np.ndarray, device):
    """The port's ``(scores0 [K, npos], e0)`` of one block ``x2d [N, C]``
    on `device`: the f32 init every encode path runs."""
    x = torch.from_numpy(np.ascontiguousarray(x2d, dtype=np.float32)).to(device)
    s0, e0, _peak = encode_init_batched(x[None], torch.from_numpy(np.asarray(bank, np.float32)).to(device))
    return s0[0].cpu().numpy(), float(e0[0])


def device_init_int(m_int: np.ndarray, prev_scale, bank_raw: np.ndarray, device):
    """The port's ``(scores0, e0)`` of one int32 map ``m_int [N, C]`` under
    hier_init='int8' (levels >= 1), through the dense int8 init on
    `device`.  The scores are bitwise `oracle.mp.int8_init_scores`; e0 is
    an f32 reduction in the backend's order, hence injected.  ``bank_raw``
    is the RAW sub-bank (``augmented[:n_raw]``)."""
    planes, step = int8_bank_tables(bank_raw)
    s0, e0, _peak = encode_init_int_batched(
        torch.from_numpy(np.asarray(m_int, np.int32)[None]).to(device),
        torch.tensor([np.float32(prev_scale)], device=device),
        torch.from_numpy(planes).to(device),
        step,
    )
    return s0[0].cpu().numpy(), float(e0[0])


def _encode_kw(cfg, level: int) -> dict:
    return dict(
        num_coefs=cfg.num_coefs[level],
        amp_bits=cfg.amp_bits,
        tolerance_snr=cfg.tolerance_snr,
        singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
        n_raw=cfg.counts[level],
        num_select=cfg.num_select,
    )


def oracle_encode_pinned(x2d, mld, level: int, device, **overrides):
    """`mp_encode` of ``x2d [N, C]`` at `level` with the port's f32 init
    injected; `overrides` replace the level's settings from the config."""
    bank = mld.augmented(level)
    scores0, e0 = device_init(x2d, bank, device)
    kw = dict(_encode_kw(mld.config, level), **overrides)
    return mp_encode(np.asarray(x2d, np.float32), bank, mld.gram(level), scores0=scores0, energy0=e0, **kw)


def oracle_hierarchical_pinned(x, mld, device):
    """Every level's oracle stream of one block ``[N]`` (or ``[N, 1]``),
    each level's init the port's: the int8 init of the level below's
    integer map at levels >= 1 under hier_init='int8', else the f32 init
    of the scaled map."""
    cfg = mld.config
    seq = np.asarray(x, np.float32)
    if seq.ndim == 1:
        seq = seq[:, None]
    streams = []
    seq_int, prev_scale = None, np.float32(0)
    for level in range(cfg.num_levels):
        if level >= 1 and cfg.hier_init == "int8":
            bank = mld.augmented(level)
            scores0, e0 = device_init_int(seq_int, prev_scale, bank[: cfg.counts[level]], device)
            st = mp_encode(seq, bank, mld.gram(level), scores0=scores0, energy0=e0, **_encode_kw(cfg, level))
        else:
            st = oracle_encode_pinned(seq, mld, level, device)
        streams.append(st)
        if level + 1 < cfg.num_levels:
            seq_int = feature_map_int_from_events(st, cfg.num_positions(level), mld.num_atoms(level))
            seq = (seq_int.astype(np.float32) * np.float32(st.scale)).astype(np.float32)
            prev_scale = np.float32(st.scale)
    return streams
