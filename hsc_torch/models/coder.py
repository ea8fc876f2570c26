"""User-facing coder classes — counterparts of `hsc_tpu.models.coder`.

`ConvolutionalMatchingPursuit` binds one (bank, Gram) pair and runs the
batched encode, whose init it picks once (`init_stage`): from a signal or
the level below's f32 map (the f32 init) or, at levels >= 1 under
hier_init='int8', from the events of the level below (the int8 init);
`ConvolutionalSparseCoder` is one level; and
`HierarchicalConvolutionalSparseCoder` drives the levels, the hand-offs
between them and both decode modes.

`backend`: 'cuda' runs the hand-written CUDA kernels (greedy loop, int8
init, integer and ordered decode), 'torch' their plain PyTorch
versions, 'auto' picks 'cuda' exactly when the device is a CUDA device.
Both emit identical streams and identical decoded bytes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import canonical_device, copy_to_host_async, to_device
from ..dictionary import MultilevelDictionary
from ..io import pack_corpus, unpack_corpus
from ..ops.decode import mp_decode_batch_torch, mp_decode_integer_batch_torch
from ..ops.decode_integer_kernel import mp_decode_integer_batch
from ..ops.decode_kernel import mp_decode_batch
from ..ops.encode import (
    EncodedBlock,
    encode_init_batched,
    feature_map,
    int8_init_from_events_torch,
    mp_encode_from_init_torch,
    quantizer_steps,
)
from ..ops.init_kernels import int8_init, kernel_planes
from ..ops.mp_kernels import mp_loop
from ..oracle.mp import LevelStream, rep_quantize
from ..params import LevelParams, int8_bank_tables, level_params_from_numpy
from ..utils import device_get_pipelined


def resolve_backend(backend: str, device: torch.device) -> str:
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (auto, torch or cuda)")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' needs a CUDA device")
    return backend


def check_dictionary(mld) -> None:
    """Raise unless `mld` is the port's own `MultilevelDictionary` (a JAX
    package dictionary crosses over through `params.dictionary_from_arrays`)."""
    if not isinstance(mld, MultilevelDictionary):
        kind = f"{type(mld).__module__}.{type(mld).__qualname__}"
        raise TypeError(
            f"expected hsc_torch.dictionary.MultilevelDictionary, got {kind} "
            "(hsc_torch.params.dictionary_from_arrays converts one)"
        )


def to_host(enc: EncodedBlock) -> EncodedBlock:
    """A device `EncodedBlock` as NumPy arrays: every field's copy started
    before the first wait (`utils.device_get_pipelined` of one tree)."""
    return device_get_pipelined([enc])[0]


def device_samples(xs, device) -> torch.Tensor:
    """``[B, N, C]`` (or ``[B, N]``) blocks as ``[B, N, C]`` f32 on `device`."""
    xs = to_device(torch.as_tensor(xs, dtype=torch.float32), device)
    return xs[:, :, None] if xs.dim() == 2 else xs


def pad_streams(streams, cap: int):
    """LevelStreams as fixed-shape host decode arrays ``(pos, atm, cds, cnt,
    scl)`` ([B, cap] / [B]), zero-padded past each stream's events."""
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
    return pos, atm, cds, cnt, scl


def level_streams(enc: EncodedBlock) -> list[LevelStream]:
    """Trim a host batched `EncodedBlock` to per-block streams (views of
    its event arrays; the per-block scalars read in one pass each)."""
    pos, atoms, codes = (np.asarray(a, np.int32) for a in (enc.positions, enc.atoms, enc.codes))
    scale = np.asarray(enc.scale, np.float32)
    e0 = np.asarray(enc.energy0).tolist()
    e_res = np.asarray(enc.energy_res).tolist()
    return [
        LevelStream(
            positions=pos[b, :n],
            atoms=atoms[b, :n],
            codes=codes[b, :n],
            scale=scale[b],
            energy0=e0[b],
            energy_res=e_res[b],
        )
        for b, n in enumerate(np.asarray(enc.count).tolist())
    ]


class ConvolutionalMatchingPursuit(nn.Module):
    """Greedy convolutional MP bound to one augmented bank (bank, Gram,
    selection weights and, under ``int8_init``, the int8 init planes are
    buffers)."""

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
        self.device = canonical_device(device)
        self.backend = resolve_backend(backend, self.device)
        n_raw = n_raw if n_raw is not None else int(bank.shape[0])
        # int8 init (hier_init='int8', levels >= 1): the digit planes of the
        # RAW sub-bank; singleton rows are exact passthroughs of the map
        self.int8_init = bool(int8_init)
        planes, self.bank_step = (
            int8_bank_tables(np.asarray(bank)[:n_raw]) if self.int8_init else (None, None)
        )
        params = level_params_from_numpy(
            bank,
            np.ascontiguousarray(np.asarray(gram).transpose(1, 0, 2)),
            bank_planes=planes,
            bank_step=self.bank_step,
            n_raw=n_raw,
            singleton_weight=singleton_weight,
            device=self.device,
        )
        self.register_buffer("bank", params.bank)
        self.register_buffer("gram_t", params.gram_t)
        self.register_buffer("weights", params.weights)
        self.register_buffer("bank_planes", params.bank_planes)
        # the same planes in the int8-init kernel's layout, made once
        self.register_buffer(
            "init_planes",
            kernel_planes(params.bank_planes)
            if self.int8_init and self.backend == "cuda" else None,
        )
        self.num_coefs = int(num_coefs)
        self.settings = dict(
            num_coefs=int(num_coefs),
            amp_bits=int(amp_bits),
            tolerance_snr=tolerance_snr,
            num_select=int(num_select),
        )

    @property
    def params(self) -> LevelParams:
        return LevelParams(
            self.bank, self.gram_t, self.weights, None, None,
            bank_planes=self.bank_planes, bank_step=self.bank_step,
        )

    def loop_stage(self, scores0, e0, scale, inv) -> EncodedBlock:
        """The greedy-loop stage on a precomputed init; `scale`/`inv` are the
        host quantizer steps (NumPy)."""
        scale = to_device(np.asarray(scale, np.float32), self.device)
        inv = to_device(np.asarray(inv, np.float32), self.device)
        loop = mp_loop if self.backend == "cuda" else mp_encode_from_init_torch
        return loop(scores0, e0, scale, inv, self.params, **self.settings)

    def compute_coefficients(self, x) -> EncodedBlock:
        """Encode one block ``[N, C]`` (or ``[N]``): the batched encode at
        B = 1, returned without the batch axis."""
        enc = self.compute_coefficients_batch(torch.as_tensor(x, dtype=torch.float32)[None])
        return EncodedBlock(*(v[0] for v in enc))

    def compute_coefficients_batch(self, xs) -> EncodedBlock:
        """Encode ``[B, N, C]`` (or ``[B, N]``) host or device blocks or
        level maps through the f32 init, whatever ``int8_init``."""
        return self._encode_from(*encode_init_batched(device_samples(xs, self.device), self.bank))

    def init_stage(self, seq):
        """A batch's init -> ``(scores0, e0, peak)``: under ``int8_init`` of
        the emitting level's events (`init_int_batched`'s arguments), else
        of ``[B, N, C]`` device samples or f32 maps (`encode_init_batched`)."""
        if self.int8_init:
            return self.init_int_batched(*seq)
        return encode_init_batched(seq, self.bank)

    def encode_stage(self, seq) -> EncodedBlock:
        """Encode a batch of `init_stage`'s input."""
        return self._encode_from(*self.init_stage(seq))

    def _encode_from(self, scores0, e0, peak) -> EncodedBlock:
        """An init's peak copied back, the host quantizer steps, the loop."""
        scale, inv = quantizer_steps(copy_to_host_async(peak).numpy(), self.settings["amp_bits"])
        return self.loop_stage(scores0, e0, scale, inv)

    def init_int_batched(self, positions, atoms, codes, count, prev_scale, n_map: int):
        """The int8 init bound to this bank (needs ``int8_init=True``) from
        the emitting level's events: ``[B, M]`` int32 padded buffers with
        ``count [B]``, their f32 scales ``prev_scale [B]`` and the length
        `n_map` of the map they lie on -> ``(scores0, e0, peak)``.  Backend
        'cuda' runs the int8-init kernels, which build no dense map; 'torch'
        the plain version (the hand-off map, then the dense init) — the same
        scores and peak."""
        if not self.int8_init:
            raise ValueError("init_int_batched needs a coder built with int8_init=True")
        args = (positions, atoms, codes, count, prev_scale, self.bank_planes, self.bank_step)
        if self.backend == "cuda":
            return int8_init(*args, n_map=n_map, planes_cnw=self.init_planes)
        return int8_init_from_events_torch(*args, n_map=n_map)


class ConvolutionalSparseCoder(nn.Module):
    """Single-level encode/reconstruct pair (reference: `hsc/modeling.py ::
    ConvolutionalSparseCoder.encode / reconstruct`)."""

    def __init__(
        self, mld: MultilevelDictionary, level: int = 0, backend: str = "auto", *, device
    ):
        super().__init__()
        check_dictionary(mld)
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

    def encode(self, x) -> LevelStream:
        """Encode one block ``[N, C]`` (or ``[N]``): the batched encode at
        B = 1."""
        return self.encode_batch(np.array(x, np.float32)[None])[0]

    def encode_batch(self, xs) -> list[LevelStream]:
        return level_streams(to_host(self.mp.compute_coefficients_batch(xs)))

    def reconstruct(self, stream: LevelStream, n: int | None = None) -> np.ndarray:
        """Decode one stream in this level's space -> ``[n, C]`` float32
        (`n` defaults to the level's sequence length), bitwise
        `oracle.mp.mp_decode` against the augmented bank: the ordered decode
        (the CUDA kernel on the card, any C) at B = 1."""
        if n is None:
            n = self.cfg.seq_len(self.level)
        cap = max(self.mp.num_coefs, 1, int(stream.positions.shape[0]))
        args = [to_device(a, self.mp.device) for a in pad_streams([stream], cap)]
        dec = mp_decode_batch if self.mp.backend == "cuda" else mp_decode_batch_torch
        return copy_to_host_async(dec(*args, self.mp.bank, n=int(n))[0]).numpy()


class HierarchicalConvolutionalSparseCoder(nn.Module):
    """Multi-level encode/reconstruct over a MultilevelDictionary: level 0
    codes the signal, level k codes the quantized level k-1 coefficient map
    (through the int8 init under hier_init='int8', the f32 init otherwise),
    and the top stream decodes in either mode."""

    def __init__(self, mld: MultilevelDictionary, backend: str = "auto", *, device):
        super().__init__()
        self.mld = mld
        self.cfg = mld.config
        self.device = canonical_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.coders = nn.ModuleList(
            [
                ConvolutionalSparseCoder(mld, level, backend=self.backend, device=self.device)
                for level in range(self.cfg.num_levels)
            ]
        )
        # ordered-decode banks: the signal-space representations per level
        self._rep_banks = {
            k: torch.from_numpy(mld.representations(k)[:, :, None]).to(self.device)
            for k in range(self.cfg.num_levels)
        }
        # integer-decode tables per (level, rep_bits): streams are
        # self-describing, so a decoder may need another rep_bits than the
        # dictionary config's
        self._rep_q_banks: dict[tuple[int, int], tuple[torch.Tensor, np.float32]] = {}

    def handoff(self, level: int, enc: EncodedBlock):
        """The level -> level+1 hand-off of a batch: for an int8 level the
        events themselves, ``(positions, atoms, codes, count, scales,
        n_map)`` as `ConvolutionalMatchingPursuit.init_int_batched` takes
        them; else the f32 maps (`hsc_tpu`'s `fmap_batched`)."""
        npos, k = self.cfg.num_positions(level), self.mld.num_atoms(level)
        if self.coders[level + 1].mp.int8_init:
            return enc.positions, enc.atoms, enc.codes, enc.count, enc.scale, npos
        return feature_map(enc, npos=npos, k=k)

    def _rep_q(self, level: int, rep_bits: int):
        key = (level, int(rep_bits))
        if key not in self._rep_q_banks:
            q, step = rep_quantize(self.mld.representations(level)[:, :, None], rep_bits)
            self._rep_q_banks[key] = (to_device(q, self.device), step)
        return self._rep_q_banks[key]

    def encode_batch_device(self, xs) -> list[EncodedBlock]:
        """Encode ``[B, N]`` (or ``[B, N, 1]``) blocks level by level -> one
        batched device `EncodedBlock` per level."""
        seq = device_samples(xs, self.device)
        levels: list[EncodedBlock] = []
        for level, coder in enumerate(self.coders):
            levels.append(coder.mp.encode_stage(seq))
            if level + 1 < self.cfg.num_levels:
                seq = self.handoff(level, levels[-1])
        return levels

    def encode(self, x) -> list[LevelStream]:
        """Encode one block ``[N]`` (or ``[N, 1]``) -> one stream per level:
        the batched encode at B = 1."""
        return self.encode_batch(np.array(x, np.float32)[None])[0]

    def encode_batch(self, xs) -> list[list[LevelStream]]:
        """Encode ``[B, N]`` blocks -> per-block lists of per-level streams."""
        per_level = [level_streams(to_host(e)) for e in self.encode_batch_device(xs)]
        return [list(block) for block in zip(*per_level)]

    def reconstruct(self, top_stream: LevelStream, level=None, mode=None, rep_bits=None) -> np.ndarray:
        """Signal-space reconstruction ``[block_size]`` of one stream of
        `level` (default: the top), bitwise `oracle.hierarchical_decode`
        (mode 'ordered') or `oracle.mp.mp_decode_integer` (mode 'integer'):
        the batched decode at B = 1, padded to the reference's capacity."""
        level = self.cfg.num_levels - 1 if level is None else level
        mode = self.cfg.decode_mode if mode is None else mode
        cap = max(self.cfg.num_coefs[level], 1, int(top_stream.positions.shape[0]))
        dev = self._decode_device_call(*pad_streams([top_stream], cap), level, mode, rep_bits)
        return copy_to_host_async(dev[0, :, 0]).numpy()

    def reconstruct_batch(self, streams, level=None, mode=None, rep_bits=None) -> np.ndarray:
        """Batched reconstruction ``[B, block_size]``, bitwise
        `oracle.mp.mp_decode_integer` (mode 'integer') or
        `oracle.hierarchical_decode` (mode 'ordered') per block."""
        dev = self.reconstruct_batch_device(streams, level=level, mode=mode, rep_bits=rep_bits)
        return copy_to_host_async(dev).numpy()[:, :, 0]

    def reconstruct_batch_device(self, streams, level=None, mode=None, rep_bits=None):
        """`reconstruct_batch` without the host copy: a device tensor
        ``[B, block_size, 1]``."""
        return self._decode_device_call(*self._decode_arrays(streams, level, mode), rep_bits)

    def _decode_device_call(self, pos, atm, cds, cnt, scl, level, mode, rep_bits):
        """The device decode of padded host arrays (`pad_streams`) ->
        ``[B, block_size, 1]``; the padding changes no output bit."""
        cuda = self.backend == "cuda"
        if mode == "integer":
            rep_q, step = self._rep_q(level, rep_bits or self.cfg.rep_bits)
            amp_step = (scl * np.float32(step)).astype(np.float32)  # f32(scale * step)
            args = [to_device(a, self.device) for a in (pos, atm, cds, cnt, amp_step)]
            dec = mp_decode_integer_batch if cuda else mp_decode_integer_batch_torch
            return dec(*args, rep_q, n=self.cfg.block_size)
        if mode != "ordered":
            raise ValueError(f"unknown decode mode {mode!r}")
        args = [to_device(a, self.device) for a in (pos, atm, cds, cnt, scl)]
        dec = mp_decode_batch if cuda else mp_decode_batch_torch
        return dec(*args, self._rep_banks[level], n=self.cfg.block_size)

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
        return (*pad_streams(streams, cap), level, mode)

    # -- corpus pipeline ------------------------------------------------------

    def encode_corpus(self, blocks: np.ndarray) -> bytes:
        """Encode ``[B, block_size]`` and bit-pack the top-level streams."""
        top = self.cfg.num_levels - 1
        return pack_corpus(self.cfg, [[(top, streams[top])] for streams in self.encode_batch(blocks)])

    def decode_corpus(self, blob: bytes) -> np.ndarray:
        """Decode a packed corpus back to ``[B, block_size]`` float32, each
        block's streams summed in container order."""
        cfg, blocks = unpack_corpus(blob)
        if cfg != self.cfg:
            raise ValueError("corpus config does not match this coder")
        out = np.zeros((len(blocks), cfg.block_size), dtype=np.float32)
        for b, streams in enumerate(blocks):
            for level, stream in streams:
                out[b] += self.reconstruct(stream, level=level)
        return out
