"""User-facing coder classes — counterparts of `hsc_tpu.models.coder`.

`ConvolutionalMatchingPursuit` binds one (bank, Gram) pair and runs the
batched encode; `ConvolutionalSparseCoder` is the single-level
encode/reconstruct pair; `HierarchicalConvolutionalSparseCoder` drives the
levels and the integer decode.  This slice of the port covers ONE level
(the flagship codec); more levels, the int8 level >= 1 init and the ordered
decode raise `NotImplementedError` naming the ROADMAP item that brings them.

`backend`: 'cuda' runs the hand-written CUDA kernels (greedy loop and
integer decode), 'torch' their plain PyTorch versions, 'auto' picks 'cuda'
exactly when the device is a CUDA device.  Both emit identical streams and
identical decoded bytes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from hsc_tpu.dictionary import MultilevelDictionary
from hsc_tpu.oracle.mp import LevelStream, rep_quantize

from ..device import resolve_device
from ..ops.decode import mp_decode_integer_batch_torch
from ..ops.decode_integer_kernel import mp_decode_integer_batch
from ..ops.encode import (
    EncodedBlock,
    encode_init_batched,
    mp_encode_from_init_torch,
    quantizer_steps,
)
from ..ops.mp_kernels import mp_loop
from ..params import LevelParams, level_params_from_numpy


def resolve_backend(backend: str, device: torch.device) -> str:
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (auto, torch or cuda)")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' needs a CUDA device")
    return backend


def to_host(enc: EncodedBlock) -> EncodedBlock:
    """A device `EncodedBlock` as NumPy arrays."""
    return EncodedBlock(*(v.cpu().numpy() for v in enc))


def level_streams(enc: EncodedBlock) -> list[LevelStream]:
    """Trim a host batched `EncodedBlock` to per-block streams."""
    out = []
    for b in range(enc.count.shape[0]):
        n = int(enc.count[b])
        out.append(
            LevelStream(
                positions=np.asarray(enc.positions[b][:n], np.int32),
                atoms=np.asarray(enc.atoms[b][:n], np.int32),
                codes=np.asarray(enc.codes[b][:n], np.int32),
                scale=np.float32(enc.scale[b]),
                energy0=float(enc.energy0[b]),
                energy_res=float(enc.energy_res[b]),
            )
        )
    return out


class ConvolutionalMatchingPursuit(nn.Module):
    """Greedy convolutional MP bound to one augmented bank (bank, Gram and
    selection weights are buffers)."""

    def __init__(
        self,
        bank: np.ndarray,
        gram: np.ndarray,
        *,
        num_coefs: int,
        amp_bits: int = 16,
        tolerance_snr: float | None = None,
        singleton_weight: float = 1.0,
        n_raw: int | None = None,
        backend: str = "auto",
        num_select: int = 1,
        int8_init: bool = False,
        device,
    ):
        super().__init__()
        if int8_init:
            raise NotImplementedError(
                "hier_init='int8' (the level >= 1 int8 init) is not ported yet "
                "(ROADMAP Queue 1, 'Hierarchy'; Queue 2, '_sparse_init_kernel')"
            )
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        params = level_params_from_numpy(
            bank,
            np.ascontiguousarray(np.asarray(gram).transpose(1, 0, 2)),
            n_raw=n_raw if n_raw is not None else int(bank.shape[0]),
            singleton_weight=singleton_weight,
            device=self.device,
        )
        self.register_buffer("bank", params.bank)
        self.register_buffer("gram_t", params.gram_t)
        self.register_buffer("weights", params.weights)
        self.num_coefs = int(num_coefs)
        self.settings = dict(
            num_coefs=int(num_coefs),
            amp_bits=int(amp_bits),
            tolerance_snr=tolerance_snr,
            num_select=int(num_select),
        )

    @property
    def params(self) -> LevelParams:
        return LevelParams(self.bank, self.gram_t, self.weights, None, None)

    def loop_stage(self, scores0, e0, scale, inv) -> EncodedBlock:
        """The greedy-loop stage on a precomputed init; `scale`/`inv` are the
        host quantizer steps (NumPy)."""
        scale = torch.from_numpy(np.asarray(scale, np.float32)).to(self.device)
        inv = torch.from_numpy(np.asarray(inv, np.float32)).to(self.device)
        loop = mp_loop if self.backend == "cuda" else mp_encode_from_init_torch
        return loop(scores0, e0, scale, inv, self.params, **self.settings)

    def compute_coefficients_batch(self, xs) -> EncodedBlock:
        """Encode ``[B, N, C]`` (or ``[B, N]``) host or device blocks."""
        xs = torch.as_tensor(xs, dtype=torch.float32).to(self.device)
        if xs.dim() == 2:
            xs = xs[:, :, None]
        scores0, e0, peak = encode_init_batched(xs, self.bank)
        scale, inv = quantizer_steps(peak.cpu().numpy(), self.settings["amp_bits"])
        return self.loop_stage(scores0, e0, scale, inv)


class ConvolutionalSparseCoder(nn.Module):
    """Single-level encoder (reference: `hsc/modeling.py ::
    ConvolutionalSparseCoder.encode`)."""

    def __init__(
        self, mld: MultilevelDictionary, level: int = 0, backend: str = "auto", *, device
    ):
        super().__init__()
        self.mld = mld
        self.level = level
        cfg = mld.config
        self.cfg = cfg
        self.mp = ConvolutionalMatchingPursuit(
            mld.augmented(level),
            mld.gram(level),
            num_coefs=cfg.num_coefs[level],
            amp_bits=cfg.amp_bits,
            tolerance_snr=cfg.tolerance_snr,
            singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
            n_raw=cfg.counts[level],
            backend=backend,
            num_select=cfg.num_select,
            int8_init=level > 0 and cfg.hier_init == "int8",
            device=device,
        )

    def encode_batch(self, xs) -> list[LevelStream]:
        return level_streams(to_host(self.mp.compute_coefficients_batch(xs)))


class HierarchicalConvolutionalSparseCoder(nn.Module):
    """Encode/reconstruct over a MultilevelDictionary — this slice: one
    level, integer decode."""

    def __init__(self, mld: MultilevelDictionary, backend: str = "auto", *, device):
        super().__init__()
        self.mld = mld
        self.cfg = mld.config
        if self.cfg.num_levels != 1:
            raise NotImplementedError(
                f"{self.cfg.num_levels}-level dictionaries are not ported yet "
                "(ROADMAP Queue 1, 'Hierarchy'); this slice runs one level"
            )
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.coders = nn.ModuleList(
            [ConvolutionalSparseCoder(mld, 0, backend=self.backend, device=self.device)]
        )
        # integer-decode tables per (level, rep_bits): streams are
        # self-describing, so a decoder may need another rep_bits than the
        # dictionary config's
        self._rep_q_banks: dict[tuple[int, int], tuple[torch.Tensor, np.float32]] = {}

    def _rep_q(self, level: int, rep_bits: int):
        key = (level, int(rep_bits))
        if key not in self._rep_q_banks:
            q, step = rep_quantize(self.mld.representations(level)[:, :, None], rep_bits)
            self._rep_q_banks[key] = (torch.from_numpy(q).to(self.device), step)
        return self._rep_q_banks[key]

    def encode_batch(self, xs) -> list[list[LevelStream]]:
        """Encode ``[B, N]`` blocks -> per-block lists of per-level streams."""
        return [[s] for s in self.coders[0].encode_batch(xs)]

    def reconstruct_batch(self, streams, level=None, mode=None, rep_bits=None) -> np.ndarray:
        """Batched reconstruction ``[B, block_size]``, bitwise
        `oracle.mp.mp_decode_integer` per block."""
        dev = self.reconstruct_batch_device(streams, level=level, mode=mode, rep_bits=rep_bits)
        return dev.cpu().numpy()[:, :, 0]

    def reconstruct_batch_device(self, streams, level=None, mode=None, rep_bits=None):
        """`reconstruct_batch` without the host copy: a device tensor
        ``[B, block_size, 1]``."""
        pos, atm, cds, cnt, scl, level, mode = self._decode_arrays(streams, level, mode)
        if mode != "integer":
            raise NotImplementedError(
                f"decode_mode={mode!r} is not ported yet (ROADMAP Queue 1, "
                "'Ordered decode reference'; Queue 2, '_decode_kernel')"
            )
        rep_q, step = self._rep_q(level, rep_bits or self.cfg.rep_bits)
        amp_step = (scl * np.float32(step)).astype(np.float32)  # f32(scale * step)
        args = [torch.from_numpy(a).to(self.device) for a in (pos, atm, cds, cnt, amp_step)]
        dec = mp_decode_integer_batch if self.backend == "cuda" else mp_decode_integer_batch_torch
        return dec(*args, rep_q, n=self.cfg.block_size)

    def _decode_arrays(self, streams, level=None, mode=None):
        """Pack LevelStreams into fixed-shape host arrays ``(pos, atm, cds,
        cnt, scl)`` ([B, cap] / [B]) plus the resolved (level, mode) — a
        copy of the JAX coder's host half, so capacities match."""
        cfg = self.cfg
        if level is None:
            level = cfg.num_levels - 1
        if mode is None:
            mode = cfg.decode_mode
        need = max([1] + [int(s.positions.shape[0]) for s in streams])
        cap = max(cfg.num_coefs[level], 1)
        if need > cap:
            # streams longer than this coder's budget (containers are
            # self-describing): bucket to the next power of two
            cap = 1 << (need - 1).bit_length()
        nb = len(streams)
        pos = np.zeros((nb, cap), np.int32)
        atm = np.zeros((nb, cap), np.int32)
        cds = np.zeros((nb, cap), np.int32)
        cnt = np.zeros((nb,), np.int32)
        scl = np.zeros((nb,), np.float32)
        for b, s in enumerate(streams):
            n = s.positions.shape[0]
            pos[b, :n], atm[b, :n], cds[b, :n], cnt[b] = s.positions, s.atoms, s.codes, n
            scl[b] = np.float32(s.scale)
        return pos, atm, cds, cnt, scl, level, mode
