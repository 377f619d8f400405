"""The segment sum of the pair decode's recompute backward on the CPU
(``ops/segment.py``): :func:`segment_sum_plain_` against
``index_put_(accumulate=True)`` in float64 and against a row-by-row
emulation of ``csrc/segment_sum.cu``'s order, and the plan of one sort a
step (:func:`chunk_sort`) applied chunk by chunk. The kernel itself is held
to the plain version on the card (``test_torch_port_cuda.py``)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from implicit_depth_torch.ops import segment

torch.set_num_threads(2)


def _skewed_index(rng, n, segments, big=0, big_seg=0):
    """Keys drawn with a heavy skew (a few segments take most rows), and
    ``big`` rows of segment ``big_seg`` besides."""
    weights = rng.pareto(1.2, size=segments) + 1e-3
    idx = rng.choice(segments, size=n - big, p=weights / weights.sum())
    idx = np.concatenate([idx, np.full(big, big_seg)])
    return torch.from_numpy(rng.permutation(idx))


def _sorted(index):
    keys, order = torch.sort(index.long(), stable=True)
    return keys, order


def _depth(n):
    """The most additions any sum of the kernel's order passes through: a
    run inside a tile, the pieces of a group, the groups, the table's add
    (and bf16 values enter exactly)."""
    pieces = -(-n // segment.SUM_TILE_ROWS) + 1
    return (segment.SUM_TILE_ROWS + -(-pieces // segment.SUM_GROUPS)
            + segment.SUM_GROUPS + 1)


def _check_against_f64(got, table0, rows, index):
    """got (S, C) f32 against index_put_(accumulate=True) of the rows in
    float64 onto table0: every element within f32 recursive summation's
    bound, depth · 2^-24 · (|table0| + the sum of the segment's |rows|)."""
    ref = table0.double().index_put_((index.long(),), rows.double(),
                                     accumulate=True)
    mag = table0.double().abs().index_put_((index.long(),),
                                           rows.double().abs(),
                                           accumulate=True)
    bound = _depth(index.shape[0]) * 2.0 ** -24 * mag
    err = (got.double() - ref).abs()
    assert (err <= bound).all(), (err - bound).max().item()
    return ref


CASES = {
    # n, segments, rows of one big segment: skewed keys with one segment of
    # many tiles (1,200 rows: 19 tiles); a row count no tile multiple
    "skewed_one_long": (3001, 40, 1200),
    "skewed": (777, 500, 0),
    "single_row": (1, 7, 0),
    "one_tile": (64, 3, 0),
    "tile_multiple_one_segment": (256, 5, 256),
    "empty": (0, 9, 0),
}


@pytest.mark.parametrize("c", [128, 155])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_segment_sum_is_index_put_within_f32_summation(case, dtype, c):
    n, segments, big = CASES[case]
    rng = np.random.default_rng(5)
    index = _skewed_index(rng, n, segments, big, big_seg=segments // 2)
    rows = torch.from_numpy(rng.normal(size=(n, c))).to(
        getattr(torch, dtype))
    table0 = torch.from_numpy(rng.normal(size=(segments, c))).float()
    keys, order = _sorted(index)
    got = segment.segment_sum_plain_(table0.clone(), rows, keys, order)
    ref = _check_against_f64(got, table0, rows, index)
    untouched = torch.ones(segments, dtype=torch.bool)
    untouched[index.long()] = False
    assert torch.equal(got[untouched], table0[untouched])  # empty segments
    assert torch.isfinite(ref).all()


def _kernel_order_by_loop(table, rows, keys, order):
    """csrc/segment_sum.cu's order, row by row in numpy float32: each tile's
    runs summed from 0; a whole segment added to its row; a crossing one as
    its pieces summed in groups, the groups in order."""
    t, groups = segment.SUM_TILE_ROWS, segment.SUM_GROUPS
    table = table.numpy().copy()
    vals = rows.float().numpy()[order.numpy()]
    keys = keys.numpy()
    n = keys.shape[0]
    pieces = {}  # segment -> [piece sums in tile order]
    for p0 in range(0, n, t):
        ends = list(range(p0, min(p0 + t, n)))
        start = p0
        for p in ends:
            if p + 1 < min(p0 + t, n) and keys[p + 1] == keys[p]:
                continue
            acc = np.zeros(table.shape[1], np.float32)
            for q in range(start, p + 1):
                acc = acc + vals[q]
            whole = (start == 0 or keys[start - 1] != keys[start]) and \
                (p + 1 == n or keys[p + 1] != keys[p])
            if whole:
                table[keys[p]] = table[keys[p]] + acc
            else:
                pieces.setdefault(keys[p], []).append(acc)
            start = p + 1
    for s, ps in pieces.items():
        sums = [np.zeros(table.shape[1], np.float32) for _ in range(groups)]
        for i, piece in enumerate(ps):
            sums[i % groups] = sums[i % groups] + piece
        total = np.zeros(table.shape[1], np.float32)
        for g in range(groups):
            total = total + sums[g]
        table[s] = table[s] + total
    return torch.from_numpy(table)


@pytest.mark.parametrize("case", ["skewed_one_long", "skewed", "single_row",
                                  "tile_multiple_one_segment"])
def test_plain_segment_sum_is_the_kernels_order_bit_for_bit(case):
    """The plain version's vectorised order is the kernel's, bit for bit (so
    that the card's test can hold the kernel to its bits)."""
    n, segments, big = CASES[case]
    rng = np.random.default_rng(8)
    index = _skewed_index(rng, n, segments, big, big_seg=1)
    rows = torch.from_numpy(rng.normal(size=(n, 5))).float()
    table0 = torch.from_numpy(rng.normal(size=(segments, 5))).float()
    keys, order = _sorted(index)
    got = segment.segment_sum_plain_(table0.clone(), rows, keys, order)
    assert torch.equal(got, _kernel_order_by_loop(table0, rows, keys, order))


@pytest.mark.parametrize("chunk", [7, 64, 100, 1000, 5000])
def test_one_sort_a_step_plans_every_chunk(chunk):
    """chunk_sort's one sort: chunk c's rows at positions [c·chunk, (c +
    1)·chunk), keys and order local to the chunk: its rows' index
    ascending, and a segment's rows in row order (stable); summed chunk by
    chunk through its slices, the table is index_put_ of the chunks in
    turn, within f32 summation."""
    rng = np.random.default_rng(chunk)
    n, segments = 1000, 60
    index = _skewed_index(rng, n, segments, 300, big_seg=7)
    keys, order = segment.chunk_sort(index, chunk, segments)
    pos = torch.arange(n)
    start = pos // chunk * chunk
    assert ((0 <= order) & (order < chunk)).all()
    assert torch.equal(keys, index[start + order])
    inside = pos[1:] % chunk != 0
    assert (keys[1:][inside] >= keys[:-1][inside]).all()
    same = inside & (keys[1:] == keys[:-1])
    assert (order[1:][same] > order[:-1][same]).all()
    rows = torch.from_numpy(rng.normal(size=(n, 155))).to(torch.bfloat16)
    table = torch.zeros(segments, 155)
    ref = torch.zeros(segments, 155, dtype=torch.float64)
    before = segment.segment_sum_.rows
    for s in range(0, n, chunk):
        k, o = keys[s:s + chunk], order[s:s + chunk]
        segment.segment_sum_(table, rows[s:s + chunk], k, o)
        ref.index_put_((index[s:s + chunk].long(),),
                       rows[s:s + chunk].double(), accumulate=True)
    assert segment.segment_sum_.rows - before == n
    mag = torch.zeros_like(ref).index_put_((index.long(),),
                                           rows.double().abs(),
                                           accumulate=True)
    chunks = -(-n // chunk)
    assert ((table.double() - ref).abs()
            <= chunks * _depth(chunk) * 2.0 ** -24 * mag).all()


def test_a_step_with_no_rows_plans_no_chunk():
    """No live rows: the sort is empty and the sum adds nothing."""
    keys, order = segment.chunk_sort(torch.zeros(0, dtype=torch.long), 64, 9)
    assert keys.shape == order.shape == (0,)
    table = torch.randn(9, 4)
    got = segment.segment_sum_(table.clone(), torch.zeros(0, 4), keys, order)
    assert torch.equal(got, table)


@pytest.mark.parametrize("name,kernel", [("SUM_TILE_ROWS", "kTileRows"),
                                         ("SUM_GROUPS", "kGroups")])
def test_the_plain_order_has_the_kernels_constants(name, kernel):
    """The plain version's order is set by the constants of
    csrc/segment_sum.cu: a change to one module alone would show only as a
    bit mismatch on the card."""
    src = (pathlib.Path(segment.__file__).parents[1] / "csrc"
           / "segment_sum.cu").read_text()
    found = re.findall(rf"constexpr int {kernel} = (\d+);", src)
    assert found == [str(getattr(segment, name))]


def test_segment_sum_refuses_what_it_cannot_take():
    keys, order = _sorted(torch.tensor([0, 1, 1]))
    with pytest.raises(ValueError, match="table"):
        segment.segment_sum_(torch.zeros(2, 3, dtype=torch.float64),
                             torch.ones(3, 3), keys, order)
    with pytest.raises(ValueError, match="rows"):
        segment.segment_sum_(torch.zeros(2, 3), torch.ones(3, 4), keys, order)
