"""The tile packing, key walk and key splits of the tensor-core prefill
kernels (the bf16 forms of ``flash_prefill`` and ``paged_flash_prefill``,
``csrc/prefill_mma.cuh``), from shapes alone.

A block takes one 64-row query tile that packs ``positions`` consecutive
query positions x ``heads`` q heads of one kv head (:func:`packing`), so
every K/V tile it reads serves the whole GQA group. Its key walk runs
from the oldest row's band start to the newest row's last key
(:func:`key_walk`) in 64-key tiles; when the tiles alone leave fewer than
two blocks an SM and the span is long, each walk is cut into ``splits``
runs of whole tiles (:func:`prefill_splits`, :func:`split_keys`) whose f32
partials the kernel merges by log-sum-exp. The split count never reads kv_lens or offsets:
the wrappers need no host sync and graph capture keeps working.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.ops.matmul import SM_COUNT

TILE = 64        # query rows of a packed tile; keys of a key tile
MAX_SPLITS = 16
SPLIT_TILES = 8  # key tiles of the span each split walks at least


def packing(group: int) -> tuple[int, int, int]:
    """(heads, positions, head chunks) of a 64-row tile for a GQA group:
    ``heads`` = min(group, 64) q heads of one kv head x ``positions`` =
    64 // heads query positions; a group of more than 64 heads takes
    ``head chunks`` tiles per position block."""
    heads = min(group, TILE)
    return heads, TILE // heads, -(-group // heads)


def tile_rows(seq: int, group: int) -> list[tuple[int, int, int]]:
    """Every tile of one (sequence, kv head) in grid order, as (first
    position, head chunk, positions it holds)."""
    heads, positions, chunks = packing(group)
    return [(p0, hc, min(positions, seq - p0))
            for p0 in range(0, seq, positions) for hc in range(chunks)]


def grid_tiles(seq: int, group: int) -> int:
    """Tiles of one (sequence, kv head): the grid's x extent."""
    _heads, positions, chunks = packing(group)
    return -(-seq // positions) * chunks


def key_walk(p0: int, positions: int, seq: int, off: int, n_keys: int,
             window: int) -> tuple[int, int]:
    """(k_lo, last_key) of the tile whose rows sit at positions
    off + p0 .. off + p0 + positions - 1 (those below ``seq``): from the
    oldest row's band start (0 without a window, ``window`` 0) to the
    newest row's position, below ``n_keys``. Empty when last_key < k_lo."""
    newest = min(p0 + positions, seq) - 1
    last_key = min(off + newest, n_keys - 1)
    k_lo = max(0, off + p0 - window + 1) if window > 0 else 0
    return k_lo, last_key


def key_span(positions: int, window: int, cap: int) -> int:
    """The most keys one tile can meet: ``cap`` (the table's MP * ps, or
    the prompt's S) or, with a window, the band of its positions."""
    return cap if window <= 0 else min(cap, window + positions - 1)


def prefill_splits(blocks: int, span: int) -> int:
    """Splits of each tile's key walk for a grid of ``blocks`` tiles: as
    many as one wave of two blocks per SM holds, at most one per 8 key
    tiles of ``span`` (:func:`key_span`; a shorter split's f32 partials
    and merge cost more than its blocks gain) and at most 16."""
    want = 2 * SM_COUNT // max(1, blocks)
    return max(1, min(want, -(-span // TILE) // SPLIT_TILES, MAX_SPLITS))


def split_keys(k_lo: int, last_key: int, splits: int) -> list[tuple[int, int]]:
    """The keys [lo, hi) each split of a tile walks, as the kernel cuts
    them: the walk's 64-key tiles from k_lo, ceil(tiles / splits) each
    (empty: lo == hi)."""
    nkt = 0 if last_key < k_lo else (last_key - k_lo) // TILE + 1
    per = -(-nkt // splits)
    out = []
    for z in range(splits):
        ta, tb = min(nkt, z * per), min(nkt, (z + 1) * per)
        lo = k_lo + ta * TILE
        out.append((lo, max(lo, min(last_key + 1, k_lo + tb * TILE))))
    return out


def launch_splits(batch: int, seq: int, heads: int, kvn: int, window: int,
                  cap: int) -> int:
    """The split count a call of ``batch`` sequences of ``seq`` query rows
    over ``heads`` q heads and ``kvn`` kv heads launches with."""
    group = heads // kvn
    _h, positions, _c = packing(group)
    return prefill_splits(batch * kvn * grid_tiles(seq, group),
                          key_span(positions, window, cap))


def workspace(q: torch.Tensor, kvn: int, window: int,
              cap: int) -> tuple[int, torch.Tensor | None]:
    """(splits, f32 partials or None) of a launch on q [B, Sq, N, D]: the
    bf16 kernel's :func:`launch_splits` and, past one split, room for each
    split's acc, m and l of every output row (csrc/split_merge.cuh); f32 q
    takes the FMA kernel, one split."""
    b, s, n, d = q.shape
    if q.dtype == torch.float32:
        return 1, None
    splits = launch_splits(b, s, n, kvn, window, cap)
    if splits == 1:
        return 1, None
    return splits, torch.empty((splits * b * s * n * (d + 2),),
                               dtype=torch.float32, device=q.device)
