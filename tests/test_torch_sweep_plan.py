"""The gathered-tile x_sweep on the CPU: the planner that cuts an ordered
word list into tile groups, the kernel's word records
(``ops/x_sweep.py::sweep_table``), and a NumPy replay of the kernel's
index arithmetic (``csrc/x_sweep.cu``: blocks, phases, sub-cubes of 16
amplitudes spanned by register vectors, the sign split between the
block's bits and the tile's) against the chain of ``_pauli_rotation_pair`` calls,
bit for bit.  The CUDA kernel itself runs only on a card
(``test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.ops import x_sweep as xs

torch.set_num_threads(1)


def _chain(re, im, words, n):
    for theta, xm, zm, ny in words:
        re, im = xs._pauli_rotation_pair(re, im, theta, xm, zm, ny, n)
    return re, im


def _pdep(v, mask):
    """Deposit the low bits of the int array v into the set bits of mask."""
    out = np.zeros_like(v)
    for i, q in enumerate(xs._bits(mask)):
        out |= ((v >> i) & 1) << q
    return out


def _parity(v):
    v = v.copy()
    p = np.zeros_like(v)
    while v.any():
        p ^= v & 1
        v >>= 1
    return p


def _replay_kernel(re, im, table, n, tile):
    """csrc/x_sweep.cu's algorithm in NumPy float32, every product and sum
    rounded on its own, all blocks and sub-cubes of a phase at once."""
    tmask = sum(1 << q for q in tile)
    t = len(tile)
    rest_all = ((1 << n) - 1) & ~tmask
    blocks = np.arange(1 << (n - t), dtype=np.int64)
    base = _pdep(blocks, rest_all)[:, None]                  # (blocks, 1)
    state = np.stack([re.numpy(), im.numpy()], -1).copy()   # (2^n, 2)
    w, nw = 0, len(table)
    while True:
        if nw:
            vecs = [(int(table[w, 6 + i // 2]) >> (16 * (i % 2))) & 0xFFFF
                    for i in range(4)]
        else:
            vecs = [1 << i if i < t else 0 for i in range(4)]
        end = w + 1 if nw else 0
        while end < nw and not (table[end, 5] >> 8) & 1:
            end += 1
        reg_t = sum(v & -v for v in vecs)                    # the pivots
        rest_t = ((1 << t) - 1) & ~reg_t
        q = np.arange(1 << max(t - 4, 0), dtype=np.int64)
        kq = _pdep(q, rest_t)[None, :]                       # (1, cubes)
        j = np.arange(16, dtype=np.int64)
        kj = np.zeros_like(j)
        for i, v in enumerate(vecs):
            kj ^= ((j >> i) & 1) * v
        k = kq[..., None] ^ kj                               # (1, cubes, 16)
        g = base[..., None] | _pdep(k, tmask)                # (b, cubes, 16)
        a = state[g]                                         # (b, c, 16, 2)
        for v in range(w, end):
            c, s = table[v, :2].copy().view(np.float32)
            zg, ny = int(table[v, 3]), int(table[v, 4]) & 3
            xr, zr = int(table[v, 5]) & 15, (int(table[v, 5]) >> 4) & 15
            zrest = int(table[v, 5]) >> 16
            pq = _parity(base & zg) ^ _parity(kq & zrest)    # (b, cubes)
            src = a[:, :, j ^ xr]                            # new[j] reads j^x
            sign = 1 - 2 * (pq[..., None] ^ _parity((j ^ xr) & zr))
            sign = sign.astype(np.float32)
            sx, sy = src[..., 0], src[..., 1]
            pr, pi = {0: (sx, sy), 1: (-sy, sx), 2: (-sx, -sy),
                      3: (sy, -sx)}[ny]
            pr, pi = sign * pr, sign * pi
            a = np.stack([c * a[..., 0] + s * pi, c * a[..., 1] - s * pr], -1)
        state[g] = a
        w = end
        if w >= nw:
            break
    return torch.as_tensor(state[:, 0]), torch.as_tensor(state[:, 1])


def _state(n, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=1 << n).astype(np.float32)),
            torch.as_tensor(rng.normal(size=1 << n).astype(np.float32)))


N = 14
# pure X, XX, YY (z = x, n_y = 2) straddling the 9|10 boundary, and a Y
# whose Z mask reaches bit 0 and bit 13
WORDS = ([(0.01 * (q + 1), 1 << q, 0, 0) for q in (9, 10, 11, 12, 13)]
         + [(0.02, (1 << 9) | (1 << 10), 0, 0),
            (-0.03, (1 << 9) | (1 << 10), (1 << 9) | (1 << 10), 2),
            (0.04, (1 << 12) | (1 << 13), (1 << 12) | (1 << 13), 2),
            (0.05, 1 << 11, (1 << 11) | 1 | (1 << 13), 1)])


@pytest.mark.parametrize("tile_bits", [6, 8])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reversed"])
def test_gathered_sweep_equals_rotation_chain(reverse, tile_bits):
    """Tiles of 6 and 8 bits over the high words: the plan has several
    gathered groups; the kernel's replay and the CPU callable both equal
    the chain of rotations bit for bit."""
    re, im = _state(N, 7)
    seq = WORDS[::-1] if reverse else WORDS
    want = _chain(re, im, seq, N)
    plan = xs.plan_sweeps(seq, N, tile_bits)
    assert len(plan) > 1
    got = (re, im)
    for tile, ws in plan:
        got = _replay_kernel(*got, xs.sweep_table(ws, N, tile), N, tile)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    cpu = xs.make_gathered_sweeps(N, seq, tile_bits)(re, im)
    for g, w_ in zip(cpu, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("words", [
    [(0.3, 1 << 2, 0, 0)],
    [(0.1 * q, 1 << q, 0, 0) for q in range(N)],
    WORDS[5:],
], ids=["one-word", "x-every-bit", "xx-yy-y"])
def test_contiguous_sweep_replay_equals_chain(words):
    """The JAX-contract sweep (contiguous tile 0..13) through the kernel's
    records, including one phase with padded register bits."""
    re, im = _state(N, 3)
    table = xs.sweep_table(words, N, xs.TILE_BITS)
    got = _replay_kernel(re, im, table, N, tuple(range(xs.TILE_BITS)))
    for g, w_ in zip(got, _chain(re, im, words, N)):
        assert torch.equal(g, w_)


def test_empty_sweep_replay_copies():
    re, im = _state(6, 1)
    got = _replay_kernel(re, im, xs.sweep_table([], 6, 6), 6, tuple(range(6)))
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


def _random_words(rng, n, count):
    words = []
    for _ in range(count):
        k = int(rng.integers(1, 7))
        bits = rng.choice(n, size=k, replace=False)
        xm = int(sum(1 << int(b) for b in bits))
        words.append((float(rng.normal()), xm, int(rng.integers(0, 1 << n)),
                      int(rng.integers(0, 4))))
    return words


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planner_keeps_order_bounds_and_covers(seed):
    rng = np.random.default_rng(seed)
    n, t = 22, 10
    words = _random_words(rng, n, 60)
    plan = xs.plan_sweeps(words, n, t)
    assert [w for _, ws in plan for w in ws] == words      # order kept
    for tile, ws in plan:
        assert len(tile) == t and set(range(xs.LOW_BITS)) <= set(tile)
        mask = sum(1 << q for q in tile)
        assert all(w[1] & ~mask == 0 for w in ws)          # covers every x
        table = xs.sweep_table(ws, n, tile)
        starts = np.flatnonzero((table[:, 5] >> 8) & 1)
        assert starts[0] == 0
        for a, b in zip(starts, list(starts[1:]) + [len(ws)]):
            vecs = [(int(table[a, 6 + i // 2]) >> (16 * (i % 2))) & 0xFFFF
                    for i in range(4)]
            assert all(vecs) and max(vecs) < 1 << t
            assert len({v & -v for v in vecs}) == 4       # distinct pivots
            assert (table[a:b, 6:] == table[a, 6:]).all()
            for w in range(a, b):
                got = 0
                for i in xs._bits(int(table[w, 5]) & 15):
                    got ^= vecs[i]
                want = sum(1 << tile.index(q)
                           for q in xs._bits(ws[w][1]))
                assert got == want


def test_tfim24_high_words_make_one_tile():
    """TFIM-24's 10 high X words, forward and reversed: one launch of 20
    words on bits {0..3, 14..23}, in five register phases."""
    high = [(-0.003125, 1 << q, 0, 0) for q in range(14, 24)]
    plan = xs.plan_sweeps(high + high[::-1], 24)
    assert len(plan) == 1
    tile, ws = plan[0]
    assert tile == tuple(range(4)) + tuple(range(14, 24)) and len(ws) == 20
    table = xs.sweep_table(ws, 24, tile)
    assert int(((table[:, 5] >> 8) & 1).sum()) == 5


def test_planner_refuses_words_no_tile_holds():
    """A word of T + 1 flip bits, a bit at n and an empty x: refused at
    planning, on every device; a word of T flip bits gets a tile."""
    with pytest.raises(ValueError, match="fits no"):
        xs.plan_sweeps([(0.1, (1 << 15) - 1, 0, 0)], 22)
    with pytest.raises(ValueError, match="fits no"):
        xs.plan_sweeps([(0.1, 1 << 22, 0, 0)], 22)
    with pytest.raises(ValueError, match="fits no"):
        xs.make_gathered_sweeps(22, [(0.1, 0, 0, 0)])
    wide = sum(1 << q for q in range(8, 22))
    assert xs.plan_sweeps([(0.1, wide, 0, 0)], 22) == [
        (tuple(range(8, 22)), [(0.1, wide, 0, 0)])]


def test_sweep_table_refuses_words_it_cannot_hold():
    with pytest.raises(ValueError, match="leaves the tile"):
        xs.sweep_table([(0.1, 1 << 20, 0, 0)], 22, 14)
    with pytest.raises(ValueError, match="is empty"):
        xs.sweep_table([(0.1, 0, 0, 0)], 22, 14)
    with pytest.raises(ValueError, match="tile_bits"):
        xs.sweep_table([(0.1, 1, 0, 0)], 22, tuple(range(15)))
    with pytest.raises(ValueError, match="tile_bits"):
        xs.sweep_table([(0.1, 1, 0, 0)], 22, (0, 0, 1))


def _bits_mask(*qs):
    return sum(1 << q for q in qs)


# words that flip more than REG_BITS bits, between narrow ones: a pure X
# on 5 bits, and X X Y Y X Y (x on 6 bits, z on the Y bits, n_y = 3)
# whose Z reaches bit 0 and bit 13
WIDE = [(0.11, 1 << 3, 0, 0),
        (0.07, _bits_mask(1, 4, 6, 9, 12), 0, 0),
        (-0.05, _bits_mask(2, 5, 7, 8, 10, 11),
         _bits_mask(7, 8, 11, 0, 13), 3),
        (0.02, _bits_mask(2, 5), _bits_mask(2, 5), 2)]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reversed"])
def test_wide_words_equal_rotation_chain(reverse):
    """Words of 5 and 6 flip bits get phases of their own (their x as a
    register vector): the kernel's replay, on the contiguous tile and on
    gathered tiles of 8 bits, and the CPU callables equal the chain of
    rotations bit for bit."""
    re, im = _state(N, 11)
    seq = WIDE[::-1] if reverse else WIDE
    want = _chain(re, im, seq, N)
    table = xs.sweep_table(seq, N, xs.TILE_BITS)
    assert int(((table[:, 5] >> 8) & 1).sum()) == 4
    got = _replay_kernel(re, im, table, N, tuple(range(xs.TILE_BITS)))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    got = (re, im)
    for tile, ws in xs.plan_sweeps(seq, N, 8):
        got = _replay_kernel(*got, xs.sweep_table(ws, N, tile), N, tile)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    for sweep in (xs.make_x_sweep(N, WIDE, reverse=reverse),
                  xs.make_gathered_sweeps(N, seq, 8)):
        for g, w_ in zip(sweep(re, im), want):
            assert torch.equal(g, w_)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_small_state_replay_equals_chain(n):
    """A state of fewer than 16 amplitudes: the tile pads its register
    vectors with zeros, and the replay still equals the chain."""
    re, im = _state(n, n)
    words = [(0.1 * (q + 1), 1 << q, 0, 0) for q in range(n)]
    words += [(0.3, (1 << n) - 1, (1 << n) - 1, n % 4),
              (-0.2, 1, (1 << n) - 1, 1)]
    table = xs.sweep_table(words, n, n)
    got = _replay_kernel(re, im, table, n, tuple(range(n)))
    for g, w_ in zip(got, _chain(re, im, words, n)):
        assert torch.equal(g, w_)
    assert xs.make_x_sweep(n, words) is not None
