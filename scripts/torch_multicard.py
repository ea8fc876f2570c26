"""The port's parallel layer (`hsc_torch.parallel`) across several cards, each
check held bytewise to the same work on one card in the same run.

    python scripts/torch_multicard.py                        # every visible card (at least 2)
    python scripts/torch_multicard.py --cards 4 --mode mesh
    python scripts/torch_multicard.py --mode measure         # host-wall rates, idle shares, NCCL corpus time
    python scripts/torch_multicard.py --device cpu --small   # the rehearsal, on the CPU
    python scripts/torch_multicard.py --seed 1               # other dictionaries and signals

`--mode mesh`: one process, a mesh whose shard i lies on card i mod N.
  At the flat flagship (16384 samples, 64 atoms of width 32, 512
  coefficients, num_select 8; dictionary seed 7, `SignalGenerator(rates=
  2e-3)` seed 3, each plus `--seed`), 64 blocks a card and a ragged tail
  of 3, on N shards:
  `DataParallelEncoder`'s fields, `CorpusEncoder(mesh=...)`'s containers
  (top-only and distributed) and rows, `DataParallelDecoder`'s rows in both
  decode modes.  At the flagship hierarchy (counts 64/32, scales 32/96,
  num_coefs 512/192, the int8 hand-off; dictionary seed 9, signals seed 5):
  `HierarchicalDataParallelEncoder`'s fields and both containers; then a
  `hier_init='f32'` 2-level container and a 3-level one (counts 64/32/16,
  scales 32/96/288) on 32 blocks.  On 4 shards (card i mod N): `sp_loop`
  and `tp_loop` given the local init, bitwise the local kernel loop, and
  `sp_encode` / `tp_encode` with their own init; `distributed_kmeans` at
  `bench.py:291-296`'s geometry (65536 windows of 32, 64 centroids, 20
  iterations); one online-learner step on 64 flat blocks.  Then `python -m
  hsc_torch.cli encode --mesh N` against no mesh, a coder built with
  ``device='cuda'`` that runs after the current card was switched, and the
  proof that every card ran its shards: the profiler's kernel events name
  each card for the greedy loop, the int8 init and both decodes, and
  `torch.cuda.max_memory_allocated(i) > 0` on every card.
  Each result is compared with the unsharded path on card 0 and with a mesh
  of as many shards all on card 0.
`--mode nccl`: N processes, one a card, joined by
  `parallel.initialize_distributed` over ``tcp://127.0.0.1:<free port>``,
  each building its coder after joining:
  `DataParallelEncoder.encode_multihost` on a ragged corpus of 4N+3 flat
  blocks (every field equal to the one-process `encode`), and
  `CorpusEncoder.encode_multihost` on the flat flagship and the flagship
  hierarchy (journals in one directory, process 0 assembling; the
  container equal to a one-process `CorpusEncoder.encode`).  A rank that
  fails or outlives `NCCL_TIMEOUT` (900 s) fails the check.
`--mode all`: mesh, then nccl.
`--mode measure`: `CorpusEncoder` encode and decode MB/s (host wall) on
  1024 flat blocks (6 with `--small`) with the N-card mesh against one
  card, in turns (one, mesh, mesh, one), each card's device idle share
  from one profiled mesh encode and decode, and the same corpus through N
  NCCL processes (`encode_multihost`, wall time of process 0 from a barrier to
  the assembled container).

On `--device cpu` card i is ``torch.device('cpu', i)`` (distinct devices to
the port, so `parallel.dp.replica` makes its copies) and the processes join
over gloo: the control flow, not a device number.  `--small` swaps the
flagships for small geometries.  One JSON line per check ("ok", "seconds",
what was compared, the first difference or the error where it failed),
then a summary line with the card's name, the card count and the
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` lines; the
exit code is 1 if any check failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from hsc_torch import MultilevelDictionary, SignalGenerator, _build, make_test_config  # noqa: E402
from hsc_torch.device import device_name, resolve_device  # noqa: E402
from hsc_torch.models import ConvolutionalSparseCoder, HierarchicalConvolutionalSparseCoder  # noqa: E402
from hsc_torch.models.coder import to_host  # noqa: E402
from hsc_torch.ops.encode import EncodedBlock, encode_init_batched, quantizer_steps  # noqa: E402
from hsc_torch.parallel import (  # noqa: E402
    DataParallelDecoder,
    DataParallelEncoder,
    HierarchicalDataParallelEncoder,
    distributed_kmeans,
    initialize_distributed,
    make_mesh,
)
from hsc_torch.runtime import CorpusEncoder, multihost_split  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Geometry:
    flat: dict  # make_test_config's arguments; dictionary seed 7, signals seed 3
    hier: dict  # int8 hand-off; dictionary seed 9, signals seed 5
    hier3: dict
    kmeans: tuple  # (windows, window length, centroids, iterations)
    blocks_per_card: int
    tail: int  # the ragged tail past blocks_per_card x N
    few_blocks: int  # the f32 and 3-level containers
    online_blocks: int
    batch_size: int  # CorpusEncoder's per shard
    measure_blocks: int  # the flat corpus of --mode measure
    seed: int = 0  # added to every data seed (dictionaries, signals, k-means)


FLAGSHIP = Geometry(
    flat=dict(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,), num_select=8),
    hier=dict(counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192), num_select=8),
    hier3=dict(counts=(64, 32, 16), scales=(32, 96, 288), block_size=16384, num_coefs=(512, 192, 64),
               num_select=8),
    kmeans=(65536, 32, 64, 20),
    blocks_per_card=64, tail=3, few_blocks=32, online_blocks=64, batch_size=64, measure_blocks=1024,
)
SMALL = Geometry(
    flat=dict(counts=(8,), scales=(8,), block_size=512, num_coefs=(24,), num_select=2),
    hier=dict(counts=(8, 4), scales=(8, 24), block_size=512, num_coefs=(24, 12), num_select=2),
    hier3=dict(counts=(8, 4, 4), scales=(8, 24, 72), block_size=1024, num_coefs=(24, 12, 6), num_select=2),
    kmeans=(256, 8, 8, 5),
    blocks_per_card=2, tail=1, few_blocks=4, online_blocks=4, batch_size=2, measure_blocks=6,
)
# SP, TP, k-means and the online step run on this many shards, shard i on
# card i mod N, against as many shards of card 0
LOOP_SHARDS = 4
# seconds the processes of the multi-process checks may take
NCCL_TIMEOUT = 900
# the kernels' names in the profiler's events: the greedy loop, the int8
# init (its cell and score kernels), the integer and the ordered decode
KERNELS = {
    "mp_encode": ("mp_encode_kernel",),
    "sparse_init": ("cell_kernel", "score_kernel"),
    "int_decode": ("IntOp",),
    "ordered_decode": ("OrderedOp",),
}
FIELDS = EncodedBlock._fields


class Mismatch(AssertionError):
    pass


# -- the cards ------------------------------------------------------------------


def card_list(n: int, kind: str) -> list[torch.device]:
    """Card i of `n`: ``cuda:i``, or on the CPU ``cpu:i`` (a device of its
    own to the port)."""
    return [torch.device(kind, i) for i in range(n)]


def shard_devices(n_shards: int, cards: list) -> list:
    """Shard i on card i mod N."""
    return [cards[i % len(cards)] for i in range(n_shards)]


def mesh_on(axis: str, devices: list):
    return make_mesh({axis: len(devices)}, devices=devices)


def sync(cards) -> None:
    for d in cards:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def free_memory(cards) -> None:
    if any(torch.device(d).type == "cuda" for d in cards):
        torch.cuda.empty_cache()


# -- comparison -----------------------------------------------------------------


def first_diff(a, b) -> str | None:
    """None where `a` and `b` are the same bits, else where they first
    differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return f"{a.dtype}{list(a.shape)} vs {b.dtype}{list(b.shape)}"
    ua = np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")
    ub = np.ascontiguousarray(b).view(f"u{b.dtype.itemsize}")
    ne = ua != ub
    if not ne.any():
        return None
    i = tuple(int(v) for v in np.argwhere(ne)[0])
    return f"{int(ne.sum())} differ, first at {list(i)}: {a[i]!r} vs {b[i]!r}"


def same_fields(what: str, got, want, n: int) -> None:
    """Every field of two host `EncodedBlock`s, first `n` blocks, bitwise."""
    for name in FIELDS:
        d = first_diff(np.asarray(getattr(got, name))[:n], np.asarray(getattr(want, name))[:n])
        if d:
            raise Mismatch(f"{what}: {name} {d}")


def same_bytes(what: str, got: bytes, want: bytes) -> None:
    if got == want:
        return
    a, b = np.frombuffer(got, np.uint8), np.frombuffer(want, np.uint8)
    m = min(a.size, b.size)
    off = int(np.argmax(a[:m] != b[:m])) if (a[:m] != b[:m]).any() else m
    raise Mismatch(f"{what}: {len(got)} vs {len(want)} bytes, first difference at byte {off}")


def same_rows(what: str, got, want) -> None:
    d = first_diff(torch.as_tensor(got).cpu().numpy(), torch.as_tensor(want).cpu().numpy())
    if d:
        raise Mismatch(f"{what}: rows {d}")


def same_stream(what: str, got, want, b: int = 0) -> None:
    """An unbatched stream (`sp_loop`, `tp_loop`) against block `b` of a
    batched one: count, the events up to it and the residual energy."""
    c, cw = int(got.count), int(want.count[b])
    if c != cw:
        raise Mismatch(f"{what}: count {c} vs {cw}")
    for f in ("positions", "atoms", "codes"):
        d = first_diff(getattr(got, f)[:c].cpu().numpy(), getattr(want, f)[b, :c].cpu().numpy())
        if d:
            raise Mismatch(f"{what}: {f} {d}")
    d = first_diff(got.energy_res.reshape(1).cpu().numpy(), want.energy_res[b : b + 1].cpu().numpy())
    if d:
        raise Mismatch(f"{what}: energy_res {d}")


def host_stream(enc) -> EncodedBlock:
    return EncodedBlock(*(np.asarray(torch.as_tensor(v).cpu()) for v in enc))


# -- data -----------------------------------------------------------------------


def flat_data(geo: Geometry, n: int):
    cfg = make_test_config(**geo.flat)
    mld = MultilevelDictionary.generate(cfg, seed=7 + geo.seed)
    return mld, SignalGenerator(mld, rates=2e-3).generate_signals(n, cfg.block_size, seed=3 + geo.seed)


def hier_data(kw: dict, n: int, seed: int):
    cfg = make_test_config(**kw)
    mld = MultilevelDictionary.generate(cfg, seed=9 + seed)
    return mld, SignalGenerator(mld, rates=2e-3).generate_signals(n, cfg.block_size, seed=5 + seed)


def timed(fn, cards):
    sync(cards)
    t0 = time.perf_counter()
    out = fn()
    sync(cards)
    return out, time.perf_counter() - t0


# -- the mesh checks ------------------------------------------------------------


class MeshChecks:
    """Every mesh check on `cards`, each a method returning what it
    measured; `run` collects their JSON lines.  `keep` gathers the outputs
    a caller compares further (containers, fields)."""

    def __init__(self, cards: list, geo: Geometry, work: str):
        self.cards, self.geo, self.work = cards, geo, work
        self.n = len(cards)
        self.one = cards[0]
        self.keep: dict = {}
        self.nb = geo.blocks_per_card * self.n + geo.tail
        self.mld, self.xs = flat_data(geo, self.nb)
        self.hmld, self.hxs = hier_data(geo.hier, self.nb, geo.seed)

    def meshes(self, n_shards: int, axis: str = "data"):
        """(shard i on card i mod N, every shard on card 0)."""
        return (mesh_on(axis, shard_devices(n_shards, self.cards)), mesh_on(axis, [self.one] * n_shards))

    def dp_encode_flat(self) -> dict:
        coder = ConvolutionalSparseCoder(self.mld, device=self.one)
        spread, stacked = self.meshes(self.n)
        got, t_mesh = timed(lambda: DataParallelEncoder(spread, coder.mp).encode(self.xs), self.cards)
        same_fields("vs the unsharded encode", got, to_host(coder.mp.compute_coefficients_batch(self.xs)), self.nb)
        same_fields("vs the mesh on card 0", got, DataParallelEncoder(stacked, coder.mp).encode(self.xs), self.nb)
        self.keep["dp_encode_flat"] = got
        return {"blocks": self.nb, "shards": self.n, "events": int(np.sum(got.count)), "mesh_s": t_mesh}

    def corpus_flat(self) -> dict:
        return self._containers("corpus_flat", self.mld, self.xs, self.geo.batch_size)

    def dp_decode_flat(self) -> dict:
        coder = HierarchicalConvolutionalSparseCoder(self.mld, device=self.one)
        streams = [s[-1] for s in coder.encode_batch(self.xs)]
        spread, stacked = self.meshes(self.n)
        for mode in ("integer", "ordered"):
            got = DataParallelDecoder(spread, coder).decode_batch_device(streams, mode=mode).cpu()
            same_rows(f"{mode} vs one card", got, coder.reconstruct_batch_device(streams, mode=mode))
            same_rows(f"{mode} vs the mesh on card 0", got,
                      DataParallelDecoder(stacked, coder).decode_batch_device(streams, mode=mode))
        return {"blocks": self.nb, "modes": ["integer", "ordered"]}

    def dp_encode_hier(self) -> dict:
        coder = HierarchicalConvolutionalSparseCoder(self.hmld, device=self.one)
        spread, stacked = self.meshes(self.n)
        got, t_mesh = timed(lambda: HierarchicalDataParallelEncoder(spread, coder).encode(self.hxs), self.cards)
        want = [to_host(e) for e in coder.encode_batch_device(self.hxs)]
        again = HierarchicalDataParallelEncoder(stacked, coder).encode(self.hxs)
        for level, (g, w, a) in enumerate(zip(got, want, again)):
            same_fields(f"level {level} vs the unsharded encode", g, w, self.nb)
            same_fields(f"level {level} vs the mesh on card 0", g, a, self.nb)
        self.keep["dp_encode_hier"] = got
        return {"blocks": self.nb, "hier_init": self.hmld.config.hier_init, "mesh_s": t_mesh,
                "events": [int(np.sum(g.count)) for g in got]}

    def _containers(self, name: str, mld, xs, bs: int, forms=(False, True)) -> dict:
        spread, stacked = self.meshes(self.n)
        out = {"blocks": int(xs.shape[0]), "levels": mld.config.num_levels, "hier_init": mld.config.hier_init}
        for dist_ in forms:
            tag = "distributed" if dist_ else "top"
            sharded = CorpusEncoder(mld, device=self.one, batch_size=bs, mesh=spread, distributed=dist_)
            blob = sharded.encode(xs)
            local = CorpusEncoder(mld, device=self.one, batch_size=bs, distributed=dist_)
            same_bytes(f"{tag} container vs one card", blob, local.encode(xs))
            same_bytes(f"{tag} container vs the mesh on card 0", blob,
                       CorpusEncoder(mld, device=self.one, batch_size=bs, mesh=stacked,
                                     distributed=dist_).encode(xs))
            same_rows(f"{tag} decode vs one card", sharded.decode(blob), local.decode(blob))
            self.keep[f"{name}_{tag}"] = blob
            out[f"{tag}_bytes"] = len(blob)
        return out

    def corpus_hier(self) -> dict:
        return self._containers("corpus_hier", self.hmld, self.hxs, self.geo.batch_size)

    def corpus_hier_f32(self) -> dict:
        mld, xs = hier_data(dict(self.geo.hier, hier_init="f32"), self.geo.few_blocks, self.geo.seed)
        return self._containers("corpus_hier_f32", mld, xs, max(self.geo.few_blocks // (2 * self.n), 1),
                                forms=(True,))

    def corpus_hier3(self) -> dict:
        mld, xs = hier_data(self.geo.hier3, self.geo.few_blocks, self.geo.seed)
        return self._containers("corpus_hier3", mld, xs, max(self.geo.few_blocks // (2 * self.n), 1),
                                forms=(False,))

    def _loop_inputs(self):
        """The flat coder's greedy loop, its settings, block 0's init and
        quantizer steps, and its stream from the local loop."""
        mp0 = ConvolutionalSparseCoder(self.mld, device=self.one).mp
        s0, e0, peak = encode_init_batched(torch.from_numpy(self.xs[:1, :, None]).to(self.one), mp0.bank)
        sc, iv = quantizer_steps(peak.cpu().numpy(), mp0.settings["amp_bits"])
        return mp0, s0, e0, sc, iv, mp0.loop_stage(s0.clone(), e0, sc, iv)

    def _single_block(self, axis, shard_scores, loop, encode, gram) -> dict:
        """`loop` given the local init, bitwise the local loop, and `encode`
        with its own init, bitwise across placements; each timed twice a
        placement, in turns."""
        mp0, s0, e0, sc, iv, want = self._loop_inputs()
        kw = mp0.settings
        meshes = dict(zip(("spread", "card0"), self.meshes(LOOP_SHARDS, axis)))
        out = {"shards": LOOP_SHARDS, "num_coefs": kw["num_coefs"], "num_select": kw["num_select"],
               "events": int(want.count[0]), **{f"{k}_s_{t}": [] for k in ("loop", "encode") for t in meshes}}
        owns = []
        for tag in ("spread", "card0", "card0", "spread"):
            mesh = meshes[tag]
            got, s = timed(lambda: loop(mesh, shard_scores(mesh, s0[0]), e0[0], sc[0], iv[0], gram, **kw), self.cards)
            same_stream(f"{axis} loop ({tag}) given the local init vs the local loop", got, want)
            out[f"loop_s_{tag}"].append(s)
            own, s = timed(lambda: encode(mesh, self.xs[0], mp0.bank, gram, **kw), self.cards)
            out[f"encode_s_{tag}"].append(s)
            owns.append((tag, host_stream(own)))
        for tag, own in owns[1:]:
            for name in FIELDS:
                d = first_diff(getattr(own, name), getattr(owns[0][1], name))
                if d:
                    raise Mismatch(f"{axis} encode (own init) on {tag} vs on the cards: {name} {d}")
        return out

    def sp(self) -> dict:
        from hsc_torch.parallel import sp_encode
        from hsc_torch.parallel.sp import sp_loop, sp_shard_scores

        n = self.mld.config.block_size
        gram_t = ConvolutionalSparseCoder(self.mld, device=self.one).mp.gram_t
        return self._single_block("seq", lambda m, s: sp_shard_scores(m, s, n), sp_loop, sp_encode, gram_t)

    def tp(self) -> dict:
        from hsc_torch.parallel import tp_encode
        from hsc_torch.parallel.tp import tp_loop, tp_shard_scores

        gram = torch.from_numpy(self.mld.gram(0)).to(self.one)
        return self._single_block("model", tp_shard_scores, tp_loop, tp_encode, gram)

    def kmeans(self) -> dict:
        m, d, k, iters = self.geo.kmeans
        rng = np.random.default_rng(self.geo.seed)
        w = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(self.one)
        c = rng.standard_normal((k, d)).astype(np.float32)
        c = torch.from_numpy(c / np.linalg.norm(c, axis=1, keepdims=True)).to(self.one)
        meshes = dict(zip(("spread", "card0"), self.meshes(LOOP_SHARDS)))
        out = {"windows": m, "dim": d, "centroids": k, "iterations": iters, "shards": LOOP_SHARDS,
               "ms_spread": [], "ms_card0": []}
        first = [a.cpu().numpy() for a in distributed_kmeans(meshes["card0"], w, c, iters)]  # and warm
        distributed_kmeans(meshes["spread"], w, c, iters)
        for tag in ("spread", "card0", "card0", "spread"):
            res, s = timed(lambda: distributed_kmeans(meshes[tag], w, c, iters), self.cards)
            out[f"ms_{tag}"].append(s * 1e3)
            for what, a, b in zip(("centroids", "objectives"), res, first):
                diff = first_diff(a.cpu().numpy(), b)
                if diff:
                    raise Mismatch(f"k-means {what} ({tag}) vs on card 0: {diff}")
        return out

    def online(self) -> dict:
        from hsc_torch.learn import OnlineConvolutionalDictionaryLearner

        cfg = self.mld.config
        bank0 = np.asarray(self.mld.dicts[0], np.float32)
        xb = self.xs[: self.geo.online_blocks]
        res = {}
        for tag, mesh in zip(("spread", "card0"), self.meshes(LOOP_SHARDS)):
            learner = OnlineConvolutionalDictionaryLearner(
                bank0, num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, mesh=mesh, device=self.one)
            loss = learner.step(xb)
            res[tag] = (loss, learner.bank.detach().cpu().numpy())
        if res["spread"][0] != res["card0"][0]:
            raise Mismatch(f"online step loss {res['spread'][0]!r} vs {res['card0'][0]!r}")
        diff = first_diff(res["spread"][1], res["card0"][1])
        if diff:
            raise Mismatch(f"online step bank on the cards vs on card 0: {diff}")
        return {"blocks": int(xb.shape[0]), "shards": LOOP_SHARDS, "loss": res["spread"][0]}

    def cli(self) -> dict:
        work = os.path.join(self.work, "cli")
        os.makedirs(work, exist_ok=True)
        self.mld.save(os.path.join(work, "d.npz"))
        np.save(os.path.join(work, "sig.npy"), self.xs.reshape(-1))
        blobs = {}
        for tag, extra in (("local", []), ("mesh", ["--mesh", str(self.n)])):
            path = os.path.join(work, f"{tag}.hsct")
            proc = subprocess.run(
                [sys.executable, "-m", "hsc_torch.cli", "encode", "--dict", os.path.join(work, "d.npz"),
                 "--input", os.path.join(work, "sig.npy"), "--output", path, "--device", self.one.type, *extra],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"cli encode {' '.join(extra)} exited {proc.returncode}: {proc.stderr[-1500:]}")
            with open(path, "rb") as f:
                blobs[tag] = f.read()
        same_bytes(f"cli encode --mesh {self.n} vs no mesh", blobs["mesh"], blobs["local"])
        return {"blocks": self.nb, "bytes": len(blobs["mesh"])}

    def card_switch(self) -> dict:
        """A coder built with ``device='cuda'`` on card 0 keeps its card: run
        with card 1 current it gives card 0's fields and container."""
        xs = self.xs[: 2 * self.geo.batch_size]
        with torch.cuda.device(self.cards[0]):
            coder = ConvolutionalSparseCoder(self.mld, device="cuda")
            codec = CorpusEncoder(self.mld, device="cuda", batch_size=self.geo.batch_size)
            want = to_host(coder.mp.compute_coefficients_batch(xs))
            blob = codec.encode(xs)
        with torch.cuda.device(self.cards[1]):
            got = to_host(coder.mp.compute_coefficients_batch(xs))
            again = codec.encode(xs)
            rows = codec.decode(blob)
        same_fields("fields with card 1 current vs card 0 current", got, want, xs.shape[0])
        same_bytes("container with card 1 current vs card 0 current", again, blob)
        same_rows("rows with card 1 current vs card 0", rows, codec.decode(blob))
        return {"blocks": int(xs.shape[0]), "coder_device": str(coder.mp.device)}

    def cards_ran(self) -> dict:
        """The profiler's kernel events of one flat DP encode, one
        hierarchical DP encode and the DP decode in both modes name every
        card for each kernel; every card allocated memory."""
        coder = ConvolutionalSparseCoder(self.mld, device=self.one)
        hcoder = HierarchicalConvolutionalSparseCoder(self.hmld, device=self.one)
        streams = [s[-1] for s in hcoder.encode_batch(self.hxs)]
        spread, _ = self.meshes(self.n)
        dp, hdp, dec = (DataParallelEncoder(spread, coder.mp), HierarchicalDataParallelEncoder(spread, hcoder),
                        DataParallelDecoder(spread, hcoder))

        def run():
            dp.encode(self.xs)
            hdp.encode(self.hxs)
            for mode in ("integer", "ordered"):
                dec.decode_batch_device(streams, mode=mode).cpu()

        run()  # warm
        prof = card_profile(run, self.cards, os.path.join(self.work, "cards_ran.json"))
        want = list(range(self.n))
        missing = {k: sorted(set(want) - set(v)) for k, v in prof["kernel_cards"].items() if set(want) - set(v)}
        if missing:
            raise Mismatch(f"kernels with no launch on a card: {missing} (seen {prof['kernel_cards']})")
        mem = [torch.cuda.max_memory_allocated(i) for i in want]
        if not all(m > 0 for m in mem):
            raise Mismatch(f"a card allocated nothing: max_memory_allocated {mem}")
        return {"kernel_cards": prof["kernel_cards"], "max_memory_allocated": mem,
                "busy_ms": prof["busy_ms"], "wall_ms": prof["wall_ms"]}

    def run(self, only=None) -> list[dict]:
        names = ["dp_encode_flat", "corpus_flat", "dp_decode_flat", "dp_encode_hier", "corpus_hier",
                 "corpus_hier_f32", "corpus_hier3", "sp", "tp", "kmeans", "online", "cli"]
        if self.one.type == "cuda" and self.n >= 2:
            names.append("card_switch")
        if self.one.type == "cuda":
            names.append("cards_ran")
        return [run_check("mesh", name, getattr(self, name), self.cards)
                for name in names if only is None or name in only]


def run_check(mode: str, name: str, fn, cards) -> dict:
    """One check -> its JSON line (printed): ``ok``, its seconds, what it
    returned, and the mismatch or the error where it failed."""
    t0 = time.perf_counter()
    line = {"check": name, "mode": mode, "cards": len(cards)}
    try:
        line.update(fn())
        line["ok"] = True
    except Exception as e:  # a failed check is reported and the run goes on
        line["ok"] = False
        line["error"] = str(e)[-1500:] if isinstance(e, Mismatch) else traceback.format_exc(limit=6)[-2500:]
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    free_memory(cards)
    return line


# -- the profiler ---------------------------------------------------------------


def card_profile(fn, cards, trace_path: str) -> dict:
    """`chip_smoke.device_profile` of `fn` over `cards` -> the cards each
    kernel of `KERNELS` launched on, and each card's busy ms (its kernel,
    copy and fill intervals) and idle share over the host wall."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    prof = smoke.device_profile(fn, trace_path, cards)
    ran = prof["kernels_by_device"]
    busy, wall_ms = prof["busy_ms_by_device"], prof["wall_ms"]
    return {"kernel_cards": {k: sorted(c for c, names in ran.items() if any(p in n for n in names for p in pats))
                             for k, pats in KERNELS.items()},
            "wall_ms": wall_ms, "busy_ms": {str(c): v for c, v in busy.items()},
            "idle": {str(c): 1.0 - v / wall_ms for c, v in busy.items()}}


# -- the multi-process checks ---------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_worker(rank: int, n: int, port: int, kind: str, jobs: list, work: str) -> None:
    """One process of the multi-process checks: join, build the coders on
    this process's card, run every job on its share of the corpus; process
    0 writes the results.  An error ends the process with a non-zero exit
    code."""
    import torch.distributed as dist

    initialize_distributed(f"127.0.0.1:{port}", n, rank)  # a no-op for one process
    grouped = dist.is_initialized()
    dev = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else torch.device("cpu")
    seconds = {}
    for job in jobs:
        mld = MultilevelDictionary.load(job["dict"])
        xs = np.load(job["blocks"], mmap_mode="r")
        n_global = xs.shape[0]
        lo, hi = multihost_split(n_global, n)[rank]
        local = np.array(xs[lo:hi])
        if job["kind"] == "dp":
            dp = DataParallelEncoder(make_mesh({"data": 1}, devices=[dev]), ConvolutionalSparseCoder(mld, device=dev).mp)
            dp.encode(local[:1])  # warm
            if grouped:
                dist.barrier()
            t0 = time.perf_counter()
            enc = dp.encode_multihost(local, n_global)
            seconds[job["name"]] = time.perf_counter() - t0
            if rank == 0:
                np.savez(os.path.join(work, f"{job['name']}.npz"), **enc._asdict())
        else:
            codec = CorpusEncoder(mld, device=dev, batch_size=job["batch_size"], process_index=rank,
                                  journal_dir=os.path.join(work, f"journal_{job['name']}"))
            codec.coder.encode_batch(local[:1])  # warm
            if grouped:
                dist.barrier()
            t0 = time.perf_counter()
            blob = codec.encode_multihost(local, n_global)
            seconds[job["name"]] = time.perf_counter() - t0
            if rank == 0:
                with open(os.path.join(work, f"{job['name']}.hsct"), "wb") as f:
                    f.write(blob)
    if rank == 0:
        with open(os.path.join(work, "seconds.json"), "w") as f:
            json.dump(seconds, f)
    if grouped:
        dist.destroy_process_group()


def spawn_ranks(n: int, kind: str, jobs: list, work: str, timeout: float, target=None) -> list:
    """Start `n` processes of `target` (`nccl_worker`'s arguments) and wait
    for them -> their exit codes; a process alive at `timeout` is killed and
    its code is None."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target or nccl_worker, args=(rank, n, port, kind, jobs, work)) for rank in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def nccl_jobs(cards, geo: Geometry, work: str, n_flat: int | None = None, dp: bool = True, hier: bool = True):
    """The jobs of the multi-process checks and their one-process results:
    (jobs, {name: the one-process encode on card 0})."""
    n = len(cards)
    one = cards[0]
    nb = n_flat or geo.blocks_per_card * n + geo.tail
    mld, xs = flat_data(geo, nb)
    sets = [("flat", mld, xs)]
    if hier:
        sets.append(("hier", *hier_data(geo.hier, geo.blocks_per_card * n + geo.tail, geo.seed)))
    jobs, want = [], {}
    for tag, m, x in sets:
        m.save(os.path.join(work, f"{tag}.npz"))
        np.save(os.path.join(work, f"{tag}.npy"), x)
        jobs.append({"name": f"corpus_{tag}", "kind": "corpus", "dict": os.path.join(work, f"{tag}.npz"),
                     "blocks": os.path.join(work, f"{tag}.npy"), "batch_size": geo.batch_size})
        want[f"corpus_{tag}"] = CorpusEncoder(m, device=one, batch_size=geo.batch_size).encode(x)
    if dp:
        _, xdp = flat_data(geo, 4 * n + 3)
        np.save(os.path.join(work, "dp.npy"), xdp)
        jobs.insert(0, {"name": "dp_encode_multihost", "kind": "dp", "dict": os.path.join(work, "flat.npz"),
                        "blocks": os.path.join(work, "dp.npy")})
        enc = DataParallelEncoder(make_mesh({"data": 1}, devices=[one]), ConvolutionalSparseCoder(mld, device=one).mp)
        want["dp_encode_multihost"] = enc.encode(xdp)
    return jobs, want, nb


def run_nccl(cards, geo: Geometry, work: str, timeout: float = NCCL_TIMEOUT, target=None, **kw) -> list[dict]:
    """The multi-process checks -> their JSON lines (printed)."""
    n, kind = len(cards), cards[0].type
    work = os.path.join(work, "nccl")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    free_memory(cards)
    jobs, want, nb = nccl_jobs(cards, geo, work, **kw)
    t0 = time.perf_counter()
    codes = spawn_ranks(n, kind, jobs, work, timeout, target)
    wall = time.perf_counter() - t0
    lines = []
    seconds = {}
    if os.path.exists(os.path.join(work, "seconds.json")):
        with open(os.path.join(work, "seconds.json")) as f:
            seconds = json.load(f)

    def check(job):
        def fn():
            if codes != [0] * n:
                raise RuntimeError(f"rank exit codes {codes} (None: killed at the {timeout:.0f} s limit)")
            name = job["name"]
            if job["kind"] == "dp":
                with np.load(os.path.join(work, f"{name}.npz")) as z:
                    got = EncodedBlock(*(z[f] for f in FIELDS))
                same_fields("vs the one-process encode", got, want[name], got.count.shape[0])
                blocks = int(got.count.shape[0])
            else:
                with open(os.path.join(work, f"{name}.hsct"), "rb") as f:
                    blob = f.read()
                same_bytes("container vs the one-process encode", blob, want[name])
                blocks = nb
            backend = "none: one process" if n == 1 else "nccl" if kind == "cuda" else "gloo"
            return {"processes": n, "backend": backend, "blocks": blocks,
                    "rank0_s": seconds.get(name), "spawn_to_exit_s": wall}
        return fn

    for job in jobs:
        lines.append(run_check("nccl", job["name"], check(job), cards))
    return lines


# -- the measurements -----------------------------------------------------------


def measure(cards, geo: Geometry, work: str) -> list[dict]:
    """Host-wall MB/s of the corpus codec on one card and on the N-card
    mesh, in turns; each card's idle share in one profiled mesh encode and
    decode; the same corpus through N processes."""
    n_blocks = geo.measure_blocks
    mld, xs = flat_data(geo, n_blocks)
    spread = mesh_on("data", cards)
    one = CorpusEncoder(mld, device=cards[0], batch_size=geo.batch_size)
    mesh = CorpusEncoder(mld, device=cards[0], batch_size=geo.batch_size, mesh=spread)
    blob = one.encode(xs)
    mb = xs.nbytes / 1e6

    def check():
        same_bytes("mesh container vs one card", mesh.encode(xs), blob)
        same_rows("mesh rows vs one card", mesh.decode(blob), one.decode(blob))
        rates = {"encode_one": [], "encode_mesh": [], "decode_one": [], "decode_mesh": [], "encode_one_journal": []}
        for i, tag in enumerate(("one", "mesh", "mesh", "one", "one", "mesh")):
            codec = one if tag == "one" else mesh
            _, s = timed(lambda: codec.encode(xs), cards)
            rates[f"encode_{tag}"].append(mb / s)
            _, s = timed(lambda: codec.decode(blob), cards)
            rates[f"decode_{tag}"].append(mb / s)
            if tag == "one":  # the same encode journaling each payload, as each process of the NCCL run does
                journaled = CorpusEncoder(mld, device=cards[0], batch_size=geo.batch_size,
                                          journal_dir=os.path.join(work, f"journal_one_{i}"))
                got, s = timed(lambda: journaled.encode(xs), cards)
                same_bytes("journaled container vs one card", got, blob)
                rates["encode_one_journal"].append(mb / s)
        out = {"blocks": n_blocks, "mb": mb, **{f"{k}_mb_s": v for k, v in rates.items()}}
        if cards[0].type == "cuda":
            for what, fn in (("encode", lambda: mesh.encode(xs)), ("decode", lambda: mesh.decode(blob)),
                             ("encode_one", lambda: one.encode(xs))):
                p = card_profile(fn, cards, os.path.join(work, f"measure_{what}.json"))
                out[f"{what}_idle"], out[f"{what}_wall_ms"] = p["idle"], p["wall_ms"]
        return out

    lines = [run_check("measure", "corpus_rates", check, cards)]
    lines += run_nccl(cards, geo, work, n_flat=n_blocks, dp=False, hier=False)
    return lines


# -- main -----------------------------------------------------------------------


def smi_lines() -> list[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return out.stdout.strip().splitlines()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cards", type=int, default=None,
                   help="cards to use (default: every visible card, at least 2; on the CPU 2)")
    p.add_argument("--device", default="cuda", help="'cuda' (default; exits without a card) or 'cpu'")
    p.add_argument("--mode", default="all", choices=("mesh", "nccl", "all", "measure"))
    p.add_argument("--small", action="store_true", help="small geometries (the CPU rehearsal)")
    p.add_argument("--seed", type=int, default=0,
                   help="added to every data seed (default 0: dictionaries 7 and 9, signals 3 and 5)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    kind = resolve_device(args.device).type
    if kind == "cuda":
        visible = torch.cuda.device_count()
        n = args.cards if args.cards is not None else visible
        if n > visible:
            raise SystemExit(f"--cards {n}: only {visible} card(s) visible")
        if args.cards is None and n < 2:
            raise SystemExit(f"torch_multicard.py needs at least 2 cards; {visible} visible (--cards 1 to rehearse)")
        _build.load()  # once, before any process of --mode nccl loads it
        torch.cuda.init()  # the allocators, whose peaks are reset here
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)
    else:
        n = args.cards or 2
    cards = card_list(n, kind)
    geo = dataclasses.replace(SMALL if args.small else FLAGSHIP, seed=args.seed)
    work = tempfile.mkdtemp(prefix="hsc_multicard_")
    t0 = time.perf_counter()
    lines = []
    if args.mode in ("mesh", "all"):
        lines += MeshChecks(cards, geo, work).run()
    if args.mode in ("nccl", "all"):
        lines += run_nccl(cards, geo, work)
    if args.mode == "measure":
        lines += measure(cards, geo, work)
    shutil.rmtree(work, ignore_errors=True)
    failed = [line["check"] for line in lines if not line["ok"]]
    print(json.dumps({
        "summary": True, "ok": not failed, "mode": args.mode, "checks": len(lines), "failed": failed,
        "cards": n, "device": device_name(cards[0]), "device_count": torch.cuda.device_count() if kind == "cuda" else 0,
        "smi": smi_lines() if kind == "cuda" else [], "small": args.small, "seconds": time.perf_counter() - t0,
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
