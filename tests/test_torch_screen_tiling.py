"""The tiling of ``csrc/screen.cu``'s TMA / wgmma kernel, replayed in numpy.

``screen_tma_kernel<P>``, K5 (b)'s strided, listed and prefix forms, runs
only on the card (no interpret mode). This file replays its indexing on the
CPU, with the tiling constants read from the source, and holds the result
bit-equal to ``cuda_screen.screen_scores_plain`` on the inputs of the other
K5 (b) tests:

- the walk: each block's contiguous range of (query tile, column) items,
  query tiles slowest; a query tile's group and rows; a column's slide;
- the two tensor maps: the query tile's box of [R, P] and the slot boxes of
  desc seen as [S, n_slots, P] with byte strides (K * 256, stride * 256),
  zero past the tensor's edge, written to shared memory with the 128- or
  64-byte swizzle;
- the wgmma operands read back through their descriptors (start address,
  the stride of 8-row groups, a k-step 32 bytes on) and the m64n256k32
  accumulator's thread -> (slot row, query column) layout;
- the validity k-step (four -127 bytes on an invalid slot's row, slots
  past n_slots invalid, four +1 bytes on every query row, 32-byte
  swizzle), the three-way fold of a column's two slot rows into 32-bit
  running maxima, the 16-bit packing, the shuffle and shared-memory
  reduction and the stores of the rows inside a group;
- the ring's mbarrier protocol (stages, parities, arrivals, the query
  tile's two barriers) under random interleavings of producer, consumer
  and TMA completions.
"""

from __future__ import annotations

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from slideo_tpu_torch.ops import cuda_screen

torch.set_num_threads(1)

SCREEN_CU = Path(__file__).resolve().parents[1] / "slideo_tpu_torch" / "csrc" / "screen.cu"
ROW = 256     # bytes of an index row


def _constants() -> dict:
    src = SCREEN_CU.read_text()
    names = ("kQueryTile", "kStageBytes", "kStages", "kWarpgroup", "kConsumers", "kFloor")
    out = {n: int(re.search(rf"constexpr int {n} = (-?\d+);", src).group(1)) for n in names}
    for n in ("kInvalidWord", "kOnesWord"):
        out[n] = int(re.search(rf"constexpr uint32_t {n} = (0x[0-9A-Fa-f]+)u;", src).group(1), 16)
    return out


C = _constants()
QT, STAGE_BYTES, STAGES, WG = C["kQueryTile"], C["kStageBytes"], C["kStages"], C["kWarpgroup"]
CONSUMERS = C["kConsumers"]
WGQ = QT // CONSUMERS          # a consumer warpgroup's queries: the wgmma's N
ACC = 64 * WGQ // WG           # accumulators a thread


def _pm1(rng, *shape) -> np.ndarray:
    return np.where(rng.rand(*shape) > 0.5, 1, -1).astype(np.int8)


# --- 16-bit pairs: the consumer's packed running maxima ----------------------

def _halves(x: np.ndarray) -> np.ndarray:
    """uint32 [...] -> int16 [..., 2] (low half first)."""
    return np.ascontiguousarray(x, dtype=np.uint32).view(np.int16).reshape(*x.shape, 2)


def _pack(h: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(h, dtype=np.int16).view(np.uint32).reshape(h.shape[:-1])


def byte_perm_5410(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``__byte_perm(lo, hi, 0x5410)``: the low 16 bits of each, lo first."""
    return (lo.astype(np.uint32) & 0xFFFF) | ((hi.astype(np.uint32) & 0xFFFF) << 16)


def vmaxs2(a, b) -> np.ndarray:
    return _pack(np.maximum(_halves(a), _halves(b)))


# --- TMA and wgmma addressing ------------------------------------------------

def swizzle(addr: np.ndarray, width: int) -> np.ndarray:
    """The byte address TMA writes (and wgmma reads) for the unswizzled
    address ``addr`` under the ``width``-byte swizzle: the 16-byte unit
    (bits 4-6 at 128 B, 4-5 at 64 B, 4 at 32 B) XOR the 128-byte line's
    bits 7-9 / 7-8 / 7."""
    mask = {128: 7, 64: 3, 32: 1}[width]
    return addr ^ (((addr >> 7) & mask) << 4)


def tma_box(gmem: np.ndarray, dims, strides, box, coords) -> np.ndarray:
    """A TMA tile load of a uint8 tensor map: dims innermost first, byte
    strides of dims 1.., the box at ``coords``; elements past any dim's
    extent are zero. Returns the box [box[-1], ..., box[0]]."""
    idx = np.indices(box[::-1]).reshape(len(box), -1)[::-1]   # idx[i]: coordinate in dim i
    pos = idx + np.asarray(coords)[:, None]
    inside = np.all((pos >= 0) & (pos < np.asarray(dims)[:, None]), axis=0)
    off = pos[0] + sum(pos[i] * strides[i - 1] for i in range(1, len(box)))
    out = np.zeros(pos.shape[1], np.int8)
    out[inside] = gmem[off[inside]]
    return out.reshape(box[::-1])


def tma_store_swizzled(smem: np.ndarray, dst: int, rows: np.ndarray, width: int) -> None:
    """The box's rows [n, width] as TMA writes them at ``dst`` (aligned)."""
    n = rows.shape[0]
    addr = dst + np.arange(n)[:, None] * width + np.arange(width)[None, :]
    smem[swizzle(addr, width)] = rows


def desc_read(smem: np.ndarray, start: int, rows: int, width: int) -> np.ndarray:
    """The [rows, 32] K-major operand a wgmma descriptor names: start address
    ``start``, 8-row groups ``8 * width`` bytes apart (SBO), each row
    ``width`` bytes on, the swizzle applied to the address."""
    m = np.arange(rows)[:, None]
    addr = start + (m // 8) * (8 * width) + (m % 8) * width + np.arange(32)[None, :]
    return smem[swizzle(addr, width)]


def accumulator_map() -> tuple[np.ndarray, np.ndarray]:
    """(slot row, query column) of d[i] in thread t of the warpgroup, each
    [128, ACC]: d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8h][8j + 2 (t % 4) + e]."""
    t = np.arange(WG)[:, None]
    i = np.arange(ACC)[None, :]
    j, h, e = i // 4, (i // 2) % 2, i % 2
    return 16 * (t // 32) + (t % 32) // 4 + 8 * h, 8 * j + 2 * (t % 4) + e


ROW_OF, COL_OF = accumulator_map()


# --- the kernel, replayed ----------------------------------------------------

def plan(nq: int, rows_per_group: int, n_cols: int, grid: int):
    """The walk on min(grid, items) blocks, as the launcher sizes the grid:
    (tiles a group, each block's [lo, hi))."""
    tiles = -(-rows_per_group // QT)
    n_items = tiles * (nq // rows_per_group) * n_cols
    grid = min(grid, n_items)
    return tiles, [(b * n_items // grid, (b + 1) * n_items // grid) for b in range(grid)]


def item_at(i: int, n_cols: int, tiles_per_group: int):
    qtile, col = divmod(i, n_cols)
    group, tig = divmod(qtile, tiles_per_group)
    return qtile, col, group, tig


def emulate(query, desc, valid, n_slides, k, stride=1, slide_ids=None, n_slots=None,
            grid: int = 3) -> np.ndarray:
    """``screen_tma_kernel``'s best [R, n_cols] for the wrapper's arguments
    (the query zero-padded to the next of 64 and 128 bytes, as
    ``screen_scores`` pads it), on ``grid`` blocks."""
    query = np.asarray(query, np.int8)
    bits = query.shape[1]
    p = 64 if bits <= 64 else 128
    query = np.pad(query, ((0, 0), (0, p - bits)))
    nq = query.shape[0]
    n_slots = k // stride if n_slots is None else n_slots
    slots = STAGE_BYTES // p
    mblocks, ksteps = slots // 64, p // 32
    n_tiles = -(-n_slots // slots)
    gdesc = np.ascontiguousarray(desc, np.int8).reshape(-1)
    gvalid = np.asarray(valid, np.uint8).reshape(-1)
    gquery = query.reshape(-1)
    if slide_ids is None:
        n_cols, rows_per_group, dim2 = n_slides, nq, n_slides
    else:
        slide_ids = np.asarray(slide_ids)
        n_cols, rows_per_group, dim2 = slide_ids.shape[1], nq // slide_ids.shape[0], 1 << 20
    tiles_per_group, ranges = plan(nq, rows_per_group, n_cols, grid)
    ring = QT * p
    pens_at = ring + STAGES * STAGE_BYTES      # each stage's validity k-step, 32 B a slot
    ones_at = pens_at + STAGES * slots * 32    # the queries' +1 k-step, 32 B a row
    end_at = ones_at + WGQ * 32
    best_out = np.full((nq, n_cols), 12345, np.int32)   # rows never written keep this
    jj = np.arange(ACC // 4)
    for lo, hi in ranges:
        smem = np.zeros(end_at, np.uint8)
        row0 = swizzle(ones_at + np.arange(WGQ)[:, None] * 32 + np.arange(4), 32)
        smem[row0] = np.array([C["kOnesWord"]], np.uint32).view(np.uint8)
        t = 0
        cur_qtile = -1
        for i in range(lo, hi):
            qtile, col, group, tig = item_at(i, n_cols, tiles_per_group)
            slide = col if slide_ids is None else int(slide_ids[group, col])
            if qtile != cur_qtile:
                box = tma_box(gquery, (p, nq), (p,), (p, QT),
                              (0, group * rows_per_group + tig * QT))
                tma_store_swizzled(smem, 0, box.view(np.uint8), p)
                cur_qtile = qtile
            best = np.full((CONSUMERS, WG, ACC // 2), C["kFloor"], np.int32)
            for tile in range(n_tiles):
                s = t % STAGES
                # The producer: the slot box, and bytes 0-3 of each slot's row
                # of the validity k-step (four -127 bytes if it is invalid).
                box = tma_box(gdesc, (p, n_slots, dim2), (stride * ROW, k * ROW), (p, slots, 1),
                              (0, tile * slots, slide))[0]
                tma_store_swizzled(smem, ring + s * STAGE_BYTES, box.view(np.uint8), p)
                j = tile * slots + np.arange(slots)
                vbytes = gvalid[slide * k + np.minimum(j, n_slots - 1) * stride]
                word = np.where((j < n_slots) & (vbytes != 0), 0, C["kInvalidWord"])
                word = word.astype(np.uint32)
                rows = swizzle(pens_at + (s * slots + np.arange(slots))[:, None] * 32
                               + np.arange(4), 32)
                smem[rows] = word.view(np.uint8).reshape(slots, 4)
                # Each consumer warpgroup: one wgmma chain per M-block with its
                # half of the query tile, the validity k-step last, then one
                # three-way max for a column's two slot rows.
                for mb in range(mblocks):
                    a_start = ring + s * STAGE_BYTES + mb * 64 * p
                    for wg in range(CONSUMERS):
                        acc = np.zeros((64, WGQ), np.int32)
                        steps = [(a_start + 32 * ks, wg * WGQ * p + 32 * ks, p)
                                 for ks in range(ksteps)]
                        steps.append((pens_at + (s * slots + mb * 64) * 32, ones_at, 32))
                        for a_at, b_at, width in steps:
                            a = desc_read(smem, a_at, 64, width).view(np.int8)
                            b = desc_read(smem, b_at, WGQ, width).view(np.int8)
                            acc += a.astype(np.int32) @ b.astype(np.int32).T
                        d = acc[ROW_OF, COL_OF]                       # [thread, ACC]
                        for e in (0, 1):
                            best[wg][:, 2 * jj + e] = np.maximum.reduce(
                                [best[wg][:, 2 * jj + e], d[:, 4 * jj + e], d[:, 4 * jj + 2 + e]])
                t += 1
            # The item's end, in each warpgroup: the maxima packed in pairs,
            # lanes xor 4, 8, 16, then the warps in shared memory; thread tid
            # stores query wg * WGQ + tid.
            lanes = np.arange(WG)
            for wg in range(CONSUMERS):
                b = byte_perm_5410(best[wg][:, 2 * jj], best[wg][:, 2 * jj + 1])
                for m in (4, 8, 16):
                    b = vmaxs2(b, b[lanes ^ m])
                red = np.zeros((4, WGQ // 2), np.uint32)
                for th in lanes[(lanes % 32) // 4 == 0]:
                    red[th // 32, 4 * jj + th % 4] = b[th]
                m = vmaxs2(vmaxs2(red[0], red[1]), vmaxs2(red[2], red[3]))
                v = _halves(m[lanes >> 1]).astype(np.int32)[lanes, lanes & 1]
                q = tig * QT + wg * WGQ + lanes
                keep = q < rows_per_group
                assert ((v[keep] >= -128) | ((v[keep] >= -636) & (v[keep] <= -380))).all()
                best_out[group * rows_per_group + q[keep], col] = np.where(
                    v[keep] < -128, -254, v[keep])
    return best_out


# --- the cases of the other K5 (b) tests --------------------------------------

def _screen_case(k: int, r: int):
    """``test_torch_screen.test_screen_scores_plain_equals_pallas``'s inputs."""
    rng = np.random.RandomState(k)
    s = 5
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.25
    valid[2] = False
    query = _pm1(rng, r, 256)
    query[[3, 40, r - 1]] = 0
    desc[4, 7] = query[0]
    valid[4, 7] = True
    desc[1, 9, :128] = -query[1, :128]
    valid[1] = False
    valid[1, 9] = True
    return dict(query=query[:, :128], desc=desc, valid=valid, n_slides=s, k=k)


def _index(rng, s: int, k: int):
    """``test_torch_prevote._index``: 25% of slots invalid and zeroed, slide
    1 with no valid slot, slide 2 valid only at odd slots."""
    desc = _pm1(rng, s, k, 256)
    valid = rng.rand(s, k) > 0.25
    valid[1] = False
    valid[2, ::2] = False
    desc[~valid] = 0
    return desc, valid


def _strided_case(s: int, k: int, stride: int, r: int, seed: int):
    rng = np.random.RandomState(seed)
    desc, valid = _index(rng, s, k)
    query = _pm1(rng, r, 128)
    query[[5, 33 % r]] = 0
    desc[6 % s, 8, :128] = query[0]
    valid[6 % s, 8] = True
    return dict(query=query, desc=desc, valid=valid, n_slides=s, k=k, stride=stride)


def _listed_case(rows: int, ids, seed: int, k: int = 256, s: int = 12):
    """``test_torch_prevote.test_listed_plain_equals_pallas_revote``'s inputs
    at ``rows`` rows a group."""
    rng = np.random.RandomState(seed)
    desc, valid = _index(rng, s, k)
    ids = np.asarray(ids, np.int32)
    query = _pm1(rng, ids.shape[0] * rows, 128)
    query[::6] = 0
    desc[ids[1, 0], 17, :128] = query[rows]
    valid[ids[1, 0], 17] = True
    return dict(query=query, desc=desc, valid=valid, n_slides=s, k=k, slide_ids=ids)


def _prefix_case(k: int, ksk: int, bits: int, r: int = 256):
    """``test_torch_frame_screen._frame_case``'s index (10 slides repeated 4
    times, slide 5 valid only past its first ksk slots) and a query tile of
    the rule's 256 rows at ``bits``."""
    rng = np.random.RandomState(k + ksk + bits)
    desc = np.tile(_pm1(rng, 10, k, 256), (4, 1, 1))
    valid = np.tile(rng.rand(10, k) > 0.2, (4, 1))
    valid[5, :ksk] = False
    valid[5, ksk:] = True
    near = desc[3, rng.choice(ksk, r - 60)].copy()
    for row in near:
        row[rng.choice(bits, max(1, bits // 10), replace=False)] *= -1
    query = np.concatenate([near, _pm1(rng, 60, 256)])[:, :bits]
    query[rng.choice(r, 30, replace=False)] = 0
    return dict(query=query, desc=desc, valid=valid, n_slides=40, k=k, n_slots=ksk)


CASES = {
    # test_torch_screen.py
    "screen K=256 R=70": lambda: _screen_case(256, 70),
    "screen K=384 R=70": lambda: _screen_case(384, 70),
    "screen K=256 R=600 (three query tiles)": lambda: _screen_case(256, 600),
    "screen K=1000 R=70 (ragged stage)": lambda: _screen_case(1000, 70),
    # test_torch_prevote.py and chip_smoke.screen_cases
    "strided S=24 K=512 stride 4": lambda: _strided_case(24, 512, 4, 70, 21),
    "strided K=1000 stride 8 (125 slots)": lambda: _strided_case(6, 1000, 8, 300, 23),
    "listed 40 rows a group": lambda: _listed_case(
        40, [[3, 1, 3, 0, 11], [5, 5, 5, 5, 5], [2, 10, 1, 4, 7]], 62),
    "listed 7 rows a group": lambda: _listed_case(
        7, [[3, 1, 3, 0, 11], [5, 5, 5, 5, 5], [2, 10, 1, 4, 7]], 29),
    "listed 200 rows a group": lambda: _listed_case(200, [[3, 1, 3], [5, 5, 0]], 31, k=128),
    "listed 300 rows a group (two tiles a group)": lambda: _listed_case(
        300, [[3, 1, 3], [5, 5, 0], [2, 2, 7]], 32, k=128),
    "listed K=1000, 8 groups": lambda: _listed_case(
        25, [[(3 * g + c) % 12 for c in range(4)] for g in range(8)], 33, k=1000),
    # test_torch_frame_screen.py and chip_smoke phase 10
    "prefix K=384, 128 slots, 128 bits": lambda: _prefix_case(384, 128, 128),
    "prefix K=384, 384 slots, 64 bits": lambda: _prefix_case(384, 384, 64),
    "prefix K=200, 200 slots, 96 bits": lambda: _prefix_case(200, 200, 96),
    "prefix K=1000, 333 slots, 100 bits": lambda: _prefix_case(1000, 333, 100),
    "prefix K=1000, 1000 slots, 64 bits": lambda: _prefix_case(1000, 1000, 64),
}


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_tma_kernel_equals_plain(name):
    case = CASES[name]()
    args = {key: case[key] for key in ("n_slides", "k")}
    kw = {key: case[key] for key in ("stride", "n_slots") if key in case}
    ids = case.get("slide_ids")
    want = cuda_screen.screen_scores_plain(
        torch.from_numpy(np.ascontiguousarray(case["query"])),
        torch.from_numpy(case["desc"].reshape(-1, 256)),
        torch.from_numpy(case["valid"].reshape(-1)), *args.values(),
        slide_ids=None if ids is None else torch.from_numpy(ids), **kw).numpy()
    got = emulate(case["query"], case["desc"], case["valid"], **args, slide_ids=ids, **kw)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (want == -254).any() and (want > -254).any()


@pytest.mark.parametrize("nq, rows_per_group, n_cols, grid", [
    (256, 256, 500, 264), (16384, 16384, 500, 264), (8192, 8192, 500, 264),
    (64 * 256, 256, 64, 264), (16 * 300, 300, 64, 264), (600, 200, 5, 7), (70, 70, 5, 1)])
def test_walk_writes_every_row_once(nq, rows_per_group, n_cols, grid):
    """Every (row, column) of best is written by exactly one (block, item)
    over a walk of ``min(grid, items)`` blocks, each block's range is
    contiguous and meets at most 3 query tiles (its query tile reloads)."""
    tiles, ranges = plan(nq, rows_per_group, n_cols, grid)
    written = np.zeros((nq, n_cols), np.int32)
    for lo, hi in ranges:
        assert hi > lo
        qtiles = set()
        for i in range(lo, hi):
            qtile, col, group, tig = item_at(i, n_cols, tiles)
            qtiles.add(qtile)
            q = tig * QT + np.arange(QT)
            rows = group * rows_per_group + q[q < rows_per_group]
            written[rows, col] += 1
        assert len(qtiles) <= 3
    assert (written == 1).all()


# --- the ring's protocol ------------------------------------------------------

class _Barrier:
    """An mbarrier: ``count`` arrivals and the expected bytes complete a
    phase; a wait on parity p passes once the phase of parity p has
    completed (at the start, the phase before phase 0 counts as parity 1)."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx: int = 0):
        self.tx += tx
        self.pending -= 1
        assert self.pending >= 0
        self._complete()

    def complete_tx(self, n: int):
        self.tx -= n
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity: int) -> bool:
        return self.phase % 2 != parity


def _protocol(n_tiles: int, mblocks: int, items: list[int], seed: int) -> None:
    """Producer (one warp), the consumer warpgroups and TMA completions of
    one block as ``screen_tma_kernel`` orders them, stepped in a random
    order: no deadlock, and a stage and the query tile hold what a consumer
    expects from the start of its wgmma chain to its end. ``items`` are the
    query tiles of the block's items; a stage has ``mblocks`` units."""
    rnd = random.Random(seed)
    warps = WG // 32
    full = [_Barrier(1) for _ in range(STAGES)]
    empty = [_Barrier(CONSUMERS * warps) for _ in range(STAGES)]
    qfull, qempty = _Barrier(1), _Barrier(CONSUMERS * warps)
    stage_data, qbuf = [None] * STAGES, [None]
    inflight = []   # TMA copies not yet landed: (barrier, bytes, store)

    def producer():
        n_loads, cur, total = 0, None, len(items) * n_tiles
        for t in range(total):
            d, tile, qtile = t % STAGES, t % n_tiles, items[t // n_tiles]
            if tile == 0 and qtile != cur:
                if n_loads > 0:
                    while not qempty.passed((n_loads - 1) & 1):
                        yield
                qfull.arrive(tx=1)
                inflight.append((qfull, 1, lambda q=qtile: qbuf.__setitem__(0, q)))
                n_loads, cur = n_loads + 1, qtile
            while not empty[d].passed(((t // STAGES) & 1) ^ 1):
                yield
            full[d].arrive(tx=1)         # after the validity words
            inflight.append((full[d], 1, lambda d=d, t=t: stage_data.__setitem__(d, t)))
            yield

    per_item = n_tiles * mblocks
    units = len(items) * per_item

    def opens_qtile(u):
        i = u // per_item
        return u % per_item == 0 and (i == 0 or items[i] != items[i - 1])

    def consumer():
        started = {}                     # unit -> (stage, tile, query tile) its wgmma reads

        def issue(u):
            t = u // mblocks
            if u % mblocks == 0:
                while not full[t % STAGES].passed((t // STAGES) & 1):
                    yield
            started[u] = (t % STAGES, t, items[u // per_item])
            assert stage_data[t % STAGES] == t and qbuf[0] == items[u // per_item]

        n_loads = 1
        while not qfull.passed(0):
            yield
        yield from issue(0)
        for u in range(units):
            nxt = u + 1 < units
            fresh = nxt and opens_qtile(u + 1)
            if nxt and not fresh:
                yield from issue(u + 1)
            yield                            # unit u's wgmma finishes
            stage, t, qtile = started.pop(u)
            assert stage_data[stage] == t and qbuf[0] == qtile
            if u % mblocks == mblocks - 1:
                for _ in range(warps):       # lane 0 of each warp
                    empty[stage].arrive()
            if (u + 1) % per_item == 0:
                i = u // per_item
                if i + 1 == len(items) or items[i + 1] != items[i]:
                    for _ in range(warps):
                        qempty.arrive()
            if fresh:
                while not qfull.passed(n_loads & 1):
                    yield
                n_loads += 1
                yield from issue(u + 1)

    actors = {"producer": producer(), **{f"consumer {c}": consumer() for c in range(CONSUMERS)}}
    steps = 0
    while actors or inflight:
        steps += 1
        assert steps < 200_000, "deadlock"
        if inflight and (not actors or rnd.random() < 0.3):
            bar, n, store = inflight.pop(rnd.randrange(len(inflight)))
            store()
            bar.complete_tx(n)
            continue
        name = rnd.choice(sorted(actors))
        try:
            next(actors[name])
        except StopIteration:
            del actors[name]


@pytest.mark.parametrize("n_tiles, mblocks, items", [
    (8, 1, [0, 0]), (1, 1, [0] * 20), (3, 1, [0, 0, 1, 1, 1, 2]), (32, 1, [5]),
    (2, 1, [0, 1, 2, 3, 4]), (4, 2, [0, 0, 1]), (1, 2, [0, 1, 1, 2])])
def test_ring_protocol(n_tiles, mblocks, items):
    for seed in range(20):
        _protocol(n_tiles, mblocks, items, seed)


def test_constants_fit_the_card():
    """The stage holds whole 64-row M-blocks and one TMA box (at most 256
    rows), each consumer warpgroup's share of the query tile is a wgmma N
    (a multiple of 8 up to 256), the validity k-step puts an invalid slot
    below any valid dot and above the floor of a running max, which fits a
    16-bit half, and a block's shared memory fits an SM (228 KB, 1 KB of it
    reserved per block)."""
    assert WGQ * CONSUMERS == QT and WGQ % 8 == 0 and WGQ <= 256 and ACC == WGQ // 2
    for p in (64, 128):
        slots = STAGE_BYTES // p
        assert slots % 64 == 0 and slots <= 256
        nbytes = QT * p + STAGES * STAGE_BYTES + STAGES * slots * 32 + WGQ * 32 \
            + 2 * CONSUMERS * 4 * (WGQ // 2) * 4 + (2 * STAGES + 2) * 8 + 1024
        assert nbytes + 1024 <= 228 * 1024
    assert C["kFloor"] == -32768   # below any dot, a 16-bit half
    # An invalid slot scores its dot + 4 x -127: below any valid dot, above the floor.
    pen = 4 * int(np.array([C["kInvalidWord"]], np.uint32).view(np.int8)[0])
    assert pen == -508 and C["kFloor"] < pen - 128 and pen + 128 < -128
    assert np.array([C["kOnesWord"]], np.uint32).view(np.int8).tolist() == [1, 1, 1, 1]
