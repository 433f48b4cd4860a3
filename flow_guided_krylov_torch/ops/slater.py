"""Batched Slater-Condon matrix elements over packed determinants.

Counterpart of ``flow_guided_krylov_tpu/ops/slater.py``: one word per
spin channel up to 32 orbitals ((B, 2) rows), two from 33 to 64
((B, 4) rows ``[a_hi, a_lo, b_hi, b_lo]``, see ``ops/bits.py``):

* :func:`make_connection_fn` (one word), :func:`make_connection_fn_w2`
  (two words) and :func:`diagonal_batch` run in float32 on the device of
  the words they are given.  JAX's ``vmap`` over determinants becomes an
  explicit batch dimension and ``torch.gather``; the two-word kernel runs
  the one-word algebra on 64-bit channels.  The JAX package's one-hot
  matmul forms of the elements (``_build_pair_tables``, MXU workarounds)
  are not carried: both kernels gather ``h2`` by (p, q, r, s).
* ``*_np`` functions are the float64 host mirrors, used where final
  eigensolves need f64, and the reference for tests.

Connections come in the JAX package's order, ``[singles_a, singles_b,
doubles_aa, doubles_bb, doubles_ab]``.  Convention: alpha orbitals on
Jordan-Wigner qubits 0..n-1, beta on n..2n-1; fermionic signs are parities
of masked words.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .bits import (_POW2_32, flip_orbital2_np, join2, occupancy,
                   occupancy2, occupancy2_np, parity_between,
                   parity_between2_np, parity_between64, parity_between_np,
                   split2)
from .excitations import ExcitationSpec, build_excitation_spec

__all__ = [
    "SlaterTables", "build_tables", "diagonal_batch", "diagonal_batch_np",
    "make_connection_fn", "make_connection_fn_w2", "make_connection_fn_auto",
    "connections_batch_np",
]


@dataclass
class SlaterTables:
    """Integral-derived tensors + excitation grids for fixed (n, n_a, n_b)."""
    n_orb: int
    n_alpha: int
    n_beta: int
    e_nuc: float
    h1: np.ndarray        # (n, n)
    h2: np.ndarray        # (n, n, n, n) chemist (pq|rs)
    jj: np.ndarray        # (n, n, n): jj[p,q,r] = (pq|rr)
    ex: np.ndarray        # (n, n, n): ex[p,q,r] = (pr|rq)
    jmat: np.ndarray      # (n, n): (pp|qq)
    kmat: np.ndarray      # (n, n): (pq|qp)
    spec_a: ExcitationSpec
    spec_b: ExcitationSpec
    ab_grid: np.ndarray   # (n_ab, 4): (occA_i, virA_a, occB_j, virB_b)

    @property
    def n_connections(self) -> int:
        return (self.spec_a.n_single + self.spec_b.n_single
                + self.spec_a.n_double + self.spec_b.n_double
                + self.ab_grid.shape[0])

    def section_sizes(self) -> Tuple[int, int, int, int, int]:
        """Connections by section, in the connection order: alpha and
        beta singles, alpha and beta doubles, alpha-beta doubles."""
        return (self.spec_a.n_single, self.spec_b.n_single,
                self.spec_a.n_double, self.spec_b.n_double,
                self.ab_grid.shape[0])


def build_tables(h1: np.ndarray, h2: np.ndarray, e_nuc: float,
                 n_alpha: int, n_beta: int) -> SlaterTables:
    n = h1.shape[0]
    if n > 64:
        raise NotImplementedError(
            "two words per spin channel support n_orb <= 64")
    r = np.arange(n)
    jj = h2[:, :, r, r]                       # (n, n, n) -> jj[p,q,r]=(pq|rr)
    ex = np.empty((n, n, n))                  # ex[p,q,r] = (pr|rq) = h2[p,r,r,q]
    for rr in range(n):
        ex[:, :, rr] = h2[:, rr, rr, :]
    jmat = h2[r[:, None], r[:, None], r[None, :], r[None, :]]
    kmat = h2[r[:, None], r[None, :], r[None, :], r[:, None]]
    spec_a = build_excitation_spec(n, n_alpha)
    spec_b = (spec_a if n_beta == n_alpha else build_excitation_spec(n, n_beta))
    sa, sb = spec_a.singles, spec_b.singles
    ab = np.array(
        [(ia, aa, ib, bb) for (ia, aa) in sa for (ib, bb) in sb],
        dtype=np.int32).reshape(len(sa) * len(sb), 4)
    return SlaterTables(
        n_orb=n, n_alpha=n_alpha, n_beta=n_beta, e_nuc=float(e_nuc),
        h1=np.asarray(h1, np.float64), h2=np.asarray(h2, np.float64),
        jj=jj, ex=ex, jmat=jmat, kmat=kmat,
        spec_a=spec_a, spec_b=spec_b, ab_grid=ab)


# ---------------------------------------------------------------------------
# Diagonal elements
# ---------------------------------------------------------------------------

def _diag_from_occ(na, nb, h1d, jmat, kmat, e_nuc, mm):
    """Shared diagonal formula; ``mm`` is the (B,n)x(n,n) matmul to use.

    E = E_nuc + sum_p h_pp N_p + 1/2 sum_pq J_pq N_p N_q
        - 1/2 sum_pq K_pq (na_p na_q + nb_p nb_q)
    """
    N = na + nb
    one = (N * h1d[None, :]).sum(-1)
    coul = 0.5 * (mm(N, jmat) * N).sum(-1)
    exch = 0.5 * ((mm(na, kmat) * na).sum(-1) + (mm(nb, kmat) * nb).sum(-1))
    return e_nuc + one + coul - exch


def _channel_occupations(packed, n, occ, occ2):
    """(B, W) words -> (alpha, beta) (B, n) occupations, W = 2 or 4."""
    if n > 32:
        return occ2(packed[:, 0:2], n), occ2(packed[:, 2:4], n)
    return occ(packed[:, 0], n), occ(packed[:, 1], n)


def diagonal_batch(packed: torch.Tensor, tables: SlaterTables,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, W) int64 words -> (B,) diagonal <x|H|x> on their device, in
    ``dtype`` (float32 on the scoring paths; float64 where the exact dE2
    takes its denominators on the device).

    The matmuls run in ``dtype`` with TF32 off: mHa-level accuracy rules
    out reduced-precision accumulation.
    """
    n = tables.n_orb
    dev = packed.device
    na, nb = _channel_occupations(packed, n, occupancy, occupancy2)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return _diag_from_occ(na.to(dtype), nb.to(dtype), t(np.diag(tables.h1)),
                          t(tables.jmat), t(tables.kmat), tables.e_nuc,
                          torch.matmul)


def _occupancy_np(bits: np.ndarray, n: int) -> np.ndarray:
    return (bits[..., None] >> np.arange(n, dtype=np.uint32)) & 1


def diagonal_batch_np(packed: np.ndarray, tables: SlaterTables) -> np.ndarray:
    """Host float64 mirror of :func:`diagonal_batch`."""
    n = tables.n_orb
    na, nb = _channel_occupations(packed, n, _occupancy_np, occupancy2_np)
    return _diag_from_occ(na.astype(np.float64), nb.astype(np.float64),
                          np.diag(tables.h1), tables.jmat, tables.kmat,
                          tables.e_nuc, np.matmul)


# ---------------------------------------------------------------------------
# Occupied / virtual list extraction (host)
# ---------------------------------------------------------------------------

def _occ_vir_lists_np(bits: np.ndarray, n: int, k: int):
    """(B,) uint32 -> ((B, k), (B, n-k)) ascending orbital index lists."""
    shifts = np.arange(n, dtype=np.uint32)
    occ = ((bits[:, None] >> shifts) & 1).astype(np.int8)
    return _occ_vir_from_occ_np(occ, k)


def _occ_vir_from_occ_np(occ: np.ndarray, k: int):
    """(B, n) 0/1 -> ((B, k), (B, n-k)) ascending orbital index lists."""
    order = np.argsort(1 - occ, axis=1, kind="stable")
    return order[:, :k].astype(np.int32), order[:, k:].astype(np.int32)


# ---------------------------------------------------------------------------
# Device connection functions (torch, float32)
# ---------------------------------------------------------------------------

# connections per row chunk of the device functions: bounds the gather
# indices and temporaries of a chunk (about 0.15 KB an entry) to a few GB
CHUNK_ENTRIES = 1 << 24


def _connection_sections(tables: SlaterTables, device, parity,
                         dtype: torch.dtype = torch.float32,
                         h2_gather: Optional[Callable] = None):
    """f(pa, pb) over (B, 1) int64 channels of up to 64 bits ->
    [(alpha, beta, elems), ...] per section in the order [singles_a,
    singles_b, doubles_aa, doubles_bb, doubles_ab]: (B, c) target channels
    (the unchanged channel as (B, 1)) and (B, c) elements in ``dtype``.
    ``parity`` is the JW sign of the channel width; ``h2_gather(h2f,
    index)`` reads the flat (pq|rs) (``h2f[index]`` when None; the
    roofline tool swaps it out)."""
    n = tables.n_orb
    ka, kb = tables.n_alpha, tables.n_beta

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def i64(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64,
                            device=device)

    h1, jj, ex = f32(tables.h1), f32(tables.jj), f32(tables.ex)
    h2f = f32(tables.h2.reshape(-1))
    sing_a, sing_b = i64(tables.spec_a.singles), i64(tables.spec_b.singles)
    dbl_a, dbl_b = i64(tables.spec_a.doubles), i64(tables.spec_b.doubles)
    ab = i64(tables.ab_grid)
    orbitals = torch.arange(n, device=device)

    def h2g(p, q, r, s):
        index = ((p * n + q) * n + r) * n + s
        return h2f[index] if h2_gather is None else h2_gather(h2f, index)

    def flip(bits, p, q):
        return bits ^ (1 << p) ^ (1 << q)

    def occ_vir(occ, k):
        # occupied orbitals sort first, each group ascending: the sort key
        # (1 - occ) * n + orbital is unique per row, so no stable sort needed
        order = torch.argsort((1 - occ) * n + orbitals, dim=1)
        return order[:, :k], order[:, k:]

    def sections(pa, pb):
        B = pa.shape[0]
        occ_a = occupancy(pa[:, 0], n)
        occ_b = occupancy(pb[:, 0], n)
        fa, fb = occ_a.float(), occ_b.float()
        la, va = occ_vir(occ_a, ka)
        lb, vb = occ_vir(occ_b, kb)
        # effective single-excitation matrices, elementwise-sum form
        coul = (jj * (fa + fb)[:, None, None, :]).sum(-1)    # (B, n, n)
        m_a = (h1 + coul - (ex * fa[:, None, None, :]).sum(-1)).reshape(B, -1)
        m_b = (h1 + coul - (ex * fb[:, None, None, :]).sum(-1)).reshape(B, -1)
        out = []

        def emit(new, other, el, alpha_channel):
            out.append((new, other, el) if alpha_channel
                       else (other, new, el))

        for bits, other, lst, vlst, m, grid, alpha in (
                (pa, pb, la, va, m_a, sing_a, True),
                (pb, pa, lb, vb, m_b, sing_b, False)):
            p = lst[:, grid[:, 0]]
            q = vlst[:, grid[:, 1]]
            sign = parity(bits, p, q)
            emit(flip(bits, p, q), other, m.gather(1, p * n + q) * sign,
                 alpha)

        for bits, other, lst, vlst, grid, alpha in (
                (pa, pb, la, va, dbl_a, True),
                (pb, pa, lb, vb, dbl_b, False)):
            p = lst[:, grid[:, 0]]
            r = lst[:, grid[:, 1]]
            q = vlst[:, grid[:, 2]]
            s = vlst[:, grid[:, 3]]
            s1 = parity(bits, p, q)
            mid = flip(bits, p, q)
            s2 = parity(mid, r, s)
            emit(flip(mid, r, s), other,
                 (h2g(p, q, r, s) - h2g(p, s, r, q)) * (s1 * s2), alpha)

        # opposite spin: the sign multiplies one parity of each channel
        p = la[:, ab[:, 0]]
        q = va[:, ab[:, 1]]
        r = lb[:, ab[:, 2]]
        s = vb[:, ab[:, 3]]
        sign = parity(pa, p, q) * parity(pb, r, s)
        out.append((flip(pa, p, q), flip(pb, r, s), h2g(p, q, r, s) * sign))
        return out

    return sections


def _chunked(block, row_words: int, C: int, device, chunk: Optional[int],
             dtype: torch.dtype = torch.float32):
    """Apply ``block`` to ``chunk`` rows at a time into preallocated
    ((B, C, row_words) int64, (B, C) ``dtype``) outputs; by default a
    chunk holds about ``CHUNK_ENTRIES`` connections (at most 2048
    rows)."""
    if chunk is None:
        chunk = max(1, min(2048, CHUNK_ENTRIES // max(C, 1)))

    def connections(packed: torch.Tensor):
        B = packed.shape[0]
        if B <= chunk:
            return block(packed)
        conn = torch.empty((B, C, row_words), dtype=torch.int64,
                           device=device)
        el = torch.empty((B, C), dtype=dtype, device=device)
        for i in range(0, B, chunk):
            conn[i:i + chunk], el[i:i + chunk] = block(packed[i:i + chunk])
        return conn, el

    return connections


def make_connection_fn(tables: SlaterTables, device,
                       chunk: Optional[int] = None
                       ) -> Callable[[torch.Tensor],
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Build f(packed (B, 2) int64) -> (conn (B, C, 2) int64, elems (B, C) f32)
    for n_orb <= 32.

    C = tables.n_connections, ordered [singles_a, singles_b, doubles_aa,
    doubles_bb, doubles_ab].  All connections are valid (no masking):
    particle conservation makes the per-determinant count static.  Rows
    are processed ``chunk`` at a time (see :func:`_chunked`).
    """
    sections = _connection_sections(tables, device, parity_between)

    def block(packed):
        secs = sections(packed[:, 0:1], packed[:, 1:2])
        return (torch.cat([torch.stack([a.expand_as(e), b.expand_as(e)], -1)
                           for a, b, e in secs], 1),
                torch.cat([e for _, _, e in secs], 1))

    return _chunked(block, 2, tables.n_connections, device, chunk)


def make_connection_fn_w2(tables: SlaterTables, device,
                          chunk: Optional[int] = None,
                          dtype: torch.dtype = torch.float32
                          ) -> Callable[[torch.Tensor],
                                        Tuple[torch.Tensor, torch.Tensor]]:
    """The connection function for 33..64 orbitals: f(packed (B, 4) int64
    ``[a_hi, a_lo, b_hi, b_lo]``) -> (conn (B, C, 4) int64, elems (B, C)
    in ``dtype``), in the sections and order of :func:`make_connection_fn`.
    Scoring takes float32 elements; the exact dE2 float64.

    Each channel's two words become one 64-bit channel (``ops/bits.join2``),
    the one-word algebra runs on it with 64-bit Jordan-Wigner parities,
    and the targets are split back into [hi, lo] words section by section
    into the preallocated output.  At C = 104,760 (39 orbitals) a row's
    targets take 3.35 MB, so callers chunk their rows."""
    sections = _connection_sections(tables, device, parity_between64, dtype)
    C = tables.n_connections

    def block(packed):
        B = packed.shape[0]
        secs = sections(join2(packed[:, 0:2])[:, None],
                        join2(packed[:, 2:4])[:, None])
        conn = torch.empty((B, C, 4), dtype=torch.int64, device=device)
        el = torch.empty((B, C), dtype=dtype, device=device)
        off = 0
        for a, b, e in secs:
            c = e.shape[1]
            conn[:, off:off + c, 0:2] = split2(a)
            conn[:, off:off + c, 2:4] = split2(b)
            el[:, off:off + c] = e
            off += c
        return conn, el

    return _chunked(block, 4, C, device, chunk, dtype)


def make_connection_fn_auto(tables: SlaterTables, device):
    """The connection function for the table's width: one word per
    channel up to 32 orbitals, two above (the JAX package's
    ``connection_kernel_choice`` picks ``w2`` there; its one-hot variants
    for smaller spaces are TPU workarounds)."""
    if tables.n_orb > 32:
        return make_connection_fn_w2(tables, device)
    return make_connection_fn(tables, device)


# ---------------------------------------------------------------------------
# Host connection mirror (NumPy, float64)
# ---------------------------------------------------------------------------

def connections_batch_np(packed: np.ndarray, tables: SlaterTables,
                         chunk: int = 2048
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized float64 connections: (B, W) uint32 -> ((B, C, W), (B, C)),
    W = 2 up to 32 orbitals, 4 above (:func:`_connections_batch_np_w2`).

    Processed in ``chunk``-row slices into preallocated outputs, so the
    temporaries stay chunk-sized.
    """
    B_total = packed.shape[0]
    row_w = 4 if tables.n_orb > 32 else 2
    if B_total > chunk:
        C = tables.n_connections
        conn_out = np.empty((B_total, C, row_w), np.uint32)
        el_out = np.empty((B_total, C), np.float64)
        for i in range(0, B_total, chunk):
            c, e = connections_batch_np(packed[i:i + chunk], tables)
            conn_out[i:i + len(c)] = c
            el_out[i:i + len(e)] = e
        return conn_out, el_out
    if tables.n_orb > 32:
        return _connections_batch_np_w2(packed, tables)
    n, ka, kb = tables.n_orb, tables.n_alpha, tables.n_beta
    B = packed.shape[0]
    pa = packed[:, 0].astype(np.uint32)
    pb = packed[:, 1].astype(np.uint32)
    shifts = np.arange(n, dtype=np.uint32)
    occ_a = ((pa[:, None] >> shifts) & np.uint32(1)).astype(np.float64)
    occ_b = ((pb[:, None] >> shifts) & np.uint32(1)).astype(np.float64)
    N = occ_a + occ_b
    la, va = _occ_vir_lists_np(packed[:, 0], n, ka)
    lb, vb = _occ_vir_lists_np(packed[:, 1], n, kb)

    coul = np.einsum("pqr,br->bpq", tables.jj, N, optimize=True)
    m_a = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex, occ_a,
                                             optimize=True)
    m_b = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex, occ_b,
                                             optimize=True)
    h2 = tables.h2
    bidx = np.arange(B)[:, None]

    def flip(bits, p, q):
        # table gather instead of scalar<<array (no SIMD shift kernel)
        return bits ^ _POW2_32[p] ^ _POW2_32[q]

    out_conn = []
    out_el = []

    def emit(new_ch, other, elems, alpha_channel):
        new_ch = new_ch.astype(np.uint32)
        other = np.broadcast_to(other[:, None], new_ch.shape).astype(np.uint32)
        pair = (np.stack([new_ch, other], -1) if alpha_channel
                else np.stack([other, new_ch], -1))
        out_conn.append(pair)
        out_el.append(elems)

    for bits, lst, vlst, m, is_a, spec in (
            (pa, la, va, m_a, True, tables.spec_a),
            (pb, lb, vb, m_b, False, tables.spec_b)):
        g = spec.singles
        p = lst[:, g[:, 0]]
        q = vlst[:, g[:, 1]]
        sign = parity_between_np(bits[:, None], p, q)
        elems = m[bidx, p, q] * sign
        emit(flip(bits[:, None], p, q), (pb if is_a else pa), elems, is_a)

    for bits, lst, vlst, is_a, spec in (
            (pa, la, va, True, tables.spec_a),
            (pb, lb, vb, False, tables.spec_b)):
        g = spec.doubles
        p = lst[:, g[:, 0]]
        r = lst[:, g[:, 1]]
        q = vlst[:, g[:, 2]]
        s = vlst[:, g[:, 3]]
        s1 = parity_between_np(bits[:, None], p, q)
        mid = flip(bits[:, None], p, q)
        s2 = parity_between_np(mid, r, s)
        elems = (h2[p, q, r, s] - h2[p, s, r, q]) * (s1 * s2)
        emit(flip(mid, r, s), (pb if is_a else pa), elems, is_a)

    g = tables.ab_grid
    p = la[:, g[:, 0]]
    q = va[:, g[:, 1]]
    r = lb[:, g[:, 2]]
    s = vb[:, g[:, 3]]
    sign = (parity_between_np(pa[:, None], p, q)
            * parity_between_np(pb[:, None], r, s))
    elems = h2[p, q, r, s] * sign
    na = flip(pa[:, None], p, q).astype(np.uint32)
    nbv = flip(pb[:, None], r, s).astype(np.uint32)
    out_conn.append(np.stack([na, nbv], -1))
    out_el.append(elems)

    return np.concatenate(out_conn, axis=1), np.concatenate(out_el, axis=1)


def _connections_batch_np_w2(packed: np.ndarray, tables: SlaterTables
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-word host mirror: (B, 4) uint32 -> ((B, C, 4), (B, C) f64), in
    the device functions' section order, values by ``h2`` fancy indexing
    and signs by the uint32 two-word primitives (``ops/bits.py``)."""
    n, ka, kb = tables.n_orb, tables.n_alpha, tables.n_beta
    B = packed.shape[0]
    pa2 = packed[:, 0:2].astype(np.uint32)
    pb2 = packed[:, 2:4].astype(np.uint32)
    occ_a_i = occupancy2_np(pa2, n)
    occ_b_i = occupancy2_np(pb2, n)
    occ_a = occ_a_i.astype(np.float64)
    occ_b = occ_b_i.astype(np.float64)
    N = occ_a + occ_b
    la, va = _occ_vir_from_occ_np(occ_a_i, ka)
    lb, vb = _occ_vir_from_occ_np(occ_b_i, kb)

    coul = np.einsum("pqr,br->bpq", tables.jj, N, optimize=True)
    m_a = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex,
                                             occ_a, optimize=True)
    m_b = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex,
                                             occ_b, optimize=True)
    h2 = tables.h2
    bidx = np.arange(B)[:, None]

    def flip2(bits2, p, q):
        return flip_orbital2_np(flip_orbital2_np(bits2, p), q)

    out_conn = []
    out_el = []

    def emit(new2, other2, elems, alpha_channel):
        other = np.broadcast_to(other2[:, None, :], new2.shape)
        pair = (np.concatenate([new2, other], -1) if alpha_channel
                else np.concatenate([other, new2], -1))
        out_conn.append(pair.astype(np.uint32))
        out_el.append(elems)

    for bits2, other2, lst, vlst, m, is_a, spec in (
            (pa2, pb2, la, va, m_a, True, tables.spec_a),
            (pb2, pa2, lb, vb, m_b, False, tables.spec_b)):
        g = spec.singles
        p = lst[:, g[:, 0]]
        q = vlst[:, g[:, 1]]
        sign = parity_between2_np(bits2[:, None, :], p, q)
        elems = m[bidx, p, q] * sign
        emit(flip2(bits2[:, None, :], p, q), other2, elems, is_a)

    for bits2, other2, lst, vlst, is_a, spec in (
            (pa2, pb2, la, va, True, tables.spec_a),
            (pb2, pa2, lb, vb, False, tables.spec_b)):
        g = spec.doubles
        p = lst[:, g[:, 0]]
        r = lst[:, g[:, 1]]
        q = vlst[:, g[:, 2]]
        s = vlst[:, g[:, 3]]
        s1 = parity_between2_np(bits2[:, None, :], p, q)
        mid = flip2(bits2[:, None, :], p, q)
        s2 = parity_between2_np(mid, r, s)
        elems = (h2[p, q, r, s] - h2[p, s, r, q]) * (s1 * s2)
        emit(flip2(mid, r, s), other2, elems, is_a)

    g = tables.ab_grid
    p = la[:, g[:, 0]]
    q = va[:, g[:, 1]]
    r = lb[:, g[:, 2]]
    s = vb[:, g[:, 3]]
    sign = (parity_between2_np(pa2[:, None, :], p, q)
            * parity_between2_np(pb2[:, None, :], r, s))
    elems = h2[p, q, r, s] * sign
    na2 = flip2(pa2[:, None, :], p, q).astype(np.uint32)
    nb2 = flip2(pb2[:, None, :], r, s).astype(np.uint32)
    out_conn.append(np.concatenate([na2, nb2], -1))
    out_el.append(elems)
    return np.concatenate(out_conn, axis=1), np.concatenate(out_el, axis=1)
