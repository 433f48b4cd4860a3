"""Fused sweep of Pauli-word rotations inside statevector tiles.

Counterpart of ``flow_guided_krylov_tpu/ops/pallas_trotter.py``.  A sweep
applies exp(-i theta_w P_w) for a list of words (theta, x_mask, z_mask,
n_y), in order or reversed, to a 2^n statevector held as a (re, im)
float32 pair.  Every word's x_mask lies inside one tile: the 2^T
amplitudes that share every bit outside T chosen bit positions.  So the
whole list costs one pass over the state.  The JAX kernel's tile is the
contiguous one, bits 0..T-1; the port's kernel also takes gathered tiles
at any T positions (bits {0..3, 14..23} for TFIM-24's high words).

* :func:`_pauli_rotation_pair` — one word's rotation in plain torch, with
  the kernel's rounding: the primitive of the plain version.  It counts
  its calls on CUDA tensors in ``_pauli_rotation_pair.cuda_calls``.
* :func:`x_sweep_reference` — the plain torch version: the words one after
  another through :func:`_pauli_rotation_pair`.
* :func:`x_sweep_cuda` — the hand-written Hopper kernel
  (``csrc/x_sweep.cu``), built with ``nvcc`` at first use.
* :func:`make_x_sweep` — the JAX name and contract: a callable
  ``(re, im) -> (re, im)`` over the contiguous tile that routes by the
  tensors' device, the kernel on ``cuda`` and the plain version on
  ``cpu``.  A kernel that fails to build or launch raises.
* :func:`plan_sweeps` / :func:`make_gathered_sweeps` — cut an ordered word
  list into consecutive groups, each inside one gathered tile, and sweep
  them one launch a group.  Word order is never changed.
* :func:`half_phase_classes` — the Trotter substep's diagonal half-phase
  exp(-i dt/2 D) as a :class:`HalfPhase`: each state's class (one byte,
  up to 256 distinct angles) and each class's (cos, -sin).
  A sweep launch applies it after its load or before its store
  (``phase``, ``at``), with :func:`diag_mul`'s rounding, so the product
  equals the plain chain's bit for bit.

The JAX package routes its sweep only on a TPU and only when an
environment switch asks for it, because there each XOR became a
permutation matmul and ran 20x slower than XLA's per-rotation path.  On
Hopper the XOR is a shared-memory address, so the Trotter propagator uses
the kernel whenever the state lies on a card.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.build import build_library, find_nvcc
from ..utils.profiling import count
from .bits import _parity32

__all__ = ["TILE_BITS", "MAX_TILE_BITS", "REG_BITS", "MAX_WORDS",
           "make_x_sweep", "make_gathered_sweeps", "plan_sweeps",
           "sweep_table", "x_sweep_reference", "x_sweep_cuda", "word_table",
           "KERNEL_SOURCE", "HalfPhase", "MAX_PHASE_CLASSES", "PHASE_LOAD",
           "PHASE_STORE", "diag_mul", "half_phase_angles", "phase_table",
           "half_phase_classes", "half_phase_classes_reference",
           "half_phase_classes_cuda", "apply_half_phase"]

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "x_sweep.cu")

# log2 of the tile's amplitude count.  The kernel holds a tile in shared
# memory at 8 bytes an amplitude, so 14 (128 KB) is the largest it takes.
TILE_BITS = 14
MAX_TILE_BITS = 14
# a kernel thread holds sub-cubes of 2^REG_BITS amplitudes in registers,
# spanned by REG_BITS vectors of tile bits: single bits, or a word's whole
# x when it flips more bits than this (a phase of its own)
REG_BITS = 4
# a gathered tile always holds the lowest LOW_BITS global bits, so that
# the kernel moves whole 32-byte sectors
LOW_BITS = 4
# word records one launch takes (the kernel stages them in shared memory)
MAX_WORDS = 1024
# distinct half-phase angles a class index holds, one byte a state; past
# it the Trotter substep keeps 2^n phase tables
MAX_PHASE_CLASSES = 256
# slots of the class build's device-wide set of angles, and the diagonal
# words its kernels stage a block
PHASE_SET_SLOTS = 1 << 12
MAX_DIAG_WORDS = 2048
# the ends of a sweep launch that apply the half-phase
PHASE_LOAD, PHASE_STORE = 1, 2

Word = Tuple[float, int, int, int]           # (theta, x_mask, z_mask, n_y)


def _pauli_masks(word: str) -> Tuple[int, int, int]:
    """Pauli word (site q at position q) -> (x_mask, z_mask, n_y)."""
    x_mask = z_mask = n_y = 0
    for q, p in enumerate(word.upper()):
        if p in "XY":
            x_mask |= 1 << q
        if p in "ZY":
            z_mask |= 1 << q
        if p == "Y":
            n_y += 1
    return x_mask, z_mask, n_y


def _xor_permute(psi: torch.Tensor, x_mask: int, n_qubits: int
                 ) -> torch.Tensor:
    """psi[k ^ x_mask]: one reflection of a (left, 2, right) view per set
    bit of the mask."""
    for q in range(n_qubits):
        if (x_mask >> q) & 1:
            v = psi.view(1 << (n_qubits - 1 - q), 2, 1 << q)
            psi = v.flip(1).view(-1)
    return psi


def _cos_sin_f32(theta: float) -> Tuple[float, float]:
    """cos and sin of ``theta`` taken in float64 on the host and rounded to
    float32, as the kernel receives them (:func:`word_table`)."""
    return float(np.float32(np.cos(theta))), float(np.float32(np.sin(theta)))


def _pauli_rotation_pair(re: torch.Tensor, im: torch.Tensor, theta: float,
                         x_mask: int, z_mask: int, n_y: int, n_qubits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """psi' = exp(-i theta P) psi = cos(theta) psi - i sin(theta) (P psi)
    on a (re, im) float32 pair, with (P psi)[k] = s * i^n_y * psi[k ^ x],
    s = (-1)^parity((k ^ x) & z).  Products and sums are rounded one by
    one, in the order the kernel uses."""
    if re.is_cuda:
        _pauli_rotation_pair.cuda_calls += 1
    ct, st = _cos_sin_f32(theta)
    xr = _xor_permute(re, x_mask, n_qubits)
    xi = _xor_permute(im, x_mask, n_qubits)
    if z_mask == 0 and n_y % 4 == 0:
        # pure-X word (every TFIM off-diagonal term): no sign vector
        return ct * re + st * xi, ct * im - st * xr
    idx = torch.arange(1 << n_qubits, dtype=torch.int64, device=re.device)
    s = 1.0 - 2.0 * _parity32((idx ^ x_mask) & z_mask).to(re.dtype)
    # i^n_y * (xr + i xi), exact: the phase only swaps and negates
    p_re, p_im = {0: (xr, xi), 1: (-xi, xr), 2: (-xr, -xi),
                  3: (xi, -xr)}[n_y % 4]
    p_re = s * p_re
    p_im = s * p_im
    return ct * re + st * p_im, ct * im - st * p_re


_pauli_rotation_pair.cuda_calls = 0


class HalfPhase(NamedTuple):
    """exp(-i dt/2 D) over 2^n states: ``cls`` (2^n,) uint8, each state's
    class; ``table`` (C, 2) float32, the (cos, -sin) of each class's
    angle, classes in ascending angle."""
    cls: torch.Tensor
    table: torch.Tensor


def diag_mul(re: torch.Tensor, im: torch.Tensor, hr: torch.Tensor,
             hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re + i im) * (hr + i hi), elementwise."""
    return re * hr - im * hi, re * hi + im * hr


def apply_half_phase(re: torch.Tensor, im: torch.Tensor, phase: HalfPhase
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`diag_mul` by each state's (cos, -sin), in plain torch."""
    h = phase.table[phase.cls.long()]
    return diag_mul(re, im, h[:, 0], h[:, 1])


def x_sweep_reference(re: torch.Tensor, im: torch.Tensor,
                      words: Sequence[Word], n_qubits: int,
                      phase: Optional[HalfPhase] = None, at: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The words applied one after another, in the order given; with
    ``phase``, the half-phase before them (``at & PHASE_LOAD``) and after
    them (``at & PHASE_STORE``)."""
    if at & PHASE_LOAD:
        re, im = apply_half_phase(re, im, phase)
    for theta, xm, zm, ny in words:
        re, im = _pauli_rotation_pair(re, im, theta, xm, zm, ny, n_qubits)
    if at & PHASE_STORE:
        re, im = apply_half_phase(re, im, phase)
    return re, im


def half_phase_angles(diag: Sequence[Tuple[float, int]], n_qubits: int,
                      dt_sub: float, device) -> torch.Tensor:
    """The float32 half-phase angle dt_sub/2 * D of each of the 2^n
    states, D = sum_w c_w (-1)^popcount(k & z_w) over the diagonal words
    (c_w, z_w), summed in float32 in word order."""
    idx = torch.arange(1 << n_qubits, dtype=torch.int64, device=device)
    D = torch.zeros(1 << n_qubits, dtype=torch.float32, device=device)
    for c, zm in diag:
        sign = 1.0 - 2.0 * _parity32(idx & zm).to(torch.float32)
        D = D + float(np.float32(c)) * sign
    return 0.5 * dt_sub * D


def phase_table(angles: np.ndarray, device) -> torch.Tensor:
    """(C, 2) float32 (cos, -sin) of float32 ``angles``, each taken in
    float64 on the host and rounded to float32 (as :func:`_cos_sin_f32`),
    so no library's float32 ``cos`` enters the phase."""
    ang = np.asarray(angles, np.float32).astype(np.float64)
    table = np.stack([np.cos(ang), -np.sin(ang)], 1).astype(np.float32)
    return torch.as_tensor(table, device=device)


def half_phase_classes_reference(diag: Sequence[Tuple[float, int]],
                                 n_qubits: int, dt_sub: float, device="cpu"
                                 ) -> Optional[HalfPhase]:
    """The plain class build: :func:`half_phase_angles`, their distinct
    values in ascending order and each state's index among them.  None
    past MAX_PHASE_CLASSES distinct angles, for a NaN angle, or past
    MAX_DIAG_WORDS diagonal words, where the kernels refuse too."""
    if len(diag) > MAX_DIAG_WORDS:
        return None
    ang, where = torch.unique(half_phase_angles(diag, n_qubits, dt_sub,
                                                device), return_inverse=True)
    if len(ang) > MAX_PHASE_CLASSES or bool(torch.isnan(ang).any()):
        return None
    return HalfPhase(where.to(torch.uint8),
                     phase_table(ang.cpu().numpy(), device))


def half_phase_classes_cuda(diag: Sequence[Tuple[float, int]],
                            n_qubits: int, dt_sub: float, device
                            ) -> Optional[HalfPhase]:
    """The class build on a card, in two kernel passes over the states
    (``csrc/x_sweep.cu``): their distinct angles into a bounded set, then
    each state's class.  Nothing of 2^n size is allocated but the class
    index.  None where :func:`half_phase_classes_reference` gives None."""
    if len(diag) > MAX_DIAG_WORDS:
        return None
    dev = torch.device(device)
    records = np.zeros((len(diag), 2), np.int32)
    records[:, 0] = np.array([c for c, _ in diag], np.float32).view(np.int32)
    records[:, 1] = [zm for _, zm in diag]
    rec = torch.as_tensor(records, device=dev)
    half_dt = ctypes.c_float(float(np.float32(0.5 * dt_sub)))
    slots = torch.full((PHASE_SET_SLOTS,), -1, dtype=torch.int32, device=dev)
    state = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _checked("class build, pass 1", lib.fgk_phase_collect(
            rec.data_ptr(), len(diag), n_qubits, half_dt, slots.data_ptr(),
            PHASE_SET_SLOTS, state.data_ptr(), MAX_PHASE_CLASSES, stream))
        found, flags = state.tolist()
        if flags or found > MAX_PHASE_CLASSES:
            return None
        keys = slots.cpu().numpy()
        keys = np.sort(keys[keys != -1].view(np.float32))
        if len(keys) != found:
            raise RuntimeError(f"class build: {len(keys)} angles in the set, "
                               f"{found} counted")
        cls = torch.empty(1 << n_qubits, dtype=torch.uint8, device=dev)
        _checked("class build, pass 2", lib.fgk_phase_classify(
            rec.data_ptr(), len(diag), n_qubits, half_dt,
            torch.as_tensor(keys, device=dev).data_ptr(), len(keys),
            cls.data_ptr(), state.data_ptr(), stream))
        if state[1].item():
            raise RuntimeError("class build: a state's angle is not among "
                               "the distinct angles of pass 1")
    return HalfPhase(cls, phase_table(keys, dev))


def half_phase_classes(diag: Sequence[Tuple[float, int]], n_qubits: int,
                       dt_sub: float, device) -> Optional[HalfPhase]:
    """exp(-i dt_sub/2 * D) as a :class:`HalfPhase`, built by the kernels
    on a card and by the plain version on the CPU; equal on both, and
    equal state by state to the (cos, -sin) pair of
    ``krylov/skqd.py::_half_phase``.  None past MAX_PHASE_CLASSES distinct
    angles: the caller keeps its tables."""
    if torch.device(device).type == "cuda":
        return half_phase_classes_cuda(diag, n_qubits, dt_sub, device)
    return half_phase_classes_reference(diag, n_qubits, dt_sub, device)


def word_table(words: Sequence[Word]) -> np.ndarray:
    """(W, 5) int32 records (cos, sin, x_mask, z_mask, n_y mod 4) in the
    kernel's layout; cos and sin are taken in float64 and rounded to
    float32, with their bits stored in the first two columns."""
    table = np.zeros((len(words), 5), np.int32)
    cs = table[:, :2].view(np.float32)
    for w, (theta, xm, zm, ny) in enumerate(words):
        cs[w] = (np.cos(theta), np.sin(theta))
        table[w, 2:] = (xm, zm, ny % 4)
    return table


def _bits(mask: int) -> List[int]:
    return [q for q in range(mask.bit_length()) if (mask >> q) & 1]


def _tile_mask(tile_bits: Union[int, Sequence[int]], n_qubits: int) -> int:
    """The tile's global bit mask: ``tile_bits`` is a count T (bits
    0..T-1) or the positions themselves.  Raises unless the tile has
    between 1 and MAX_TILE_BITS distinct bits below n_qubits <= 31."""
    if isinstance(tile_bits, (int, np.integer)):
        positions = list(range(int(tile_bits)))
    else:
        positions = [int(q) for q in tile_bits]
    mask = sum(1 << q for q in set(positions) if q >= 0)
    if (len(set(positions)) != len(positions) or min(positions, default=-1) < 0
            or not 1 <= len(positions) <= MAX_TILE_BITS
            or mask >> n_qubits or n_qubits > 31):
        raise ValueError(f"tile_bits {tile_bits} must name 1 to "
                         f"{MAX_TILE_BITS} distinct bits below n_qubits "
                         f"{n_qubits} <= 31")
    return mask


def _popcount(v: int) -> int:
    return bin(v).count("1")


def sweep_table(words: Sequence[Word], n_qubits: int,
                tile_bits: Union[int, Sequence[int]]) -> np.ndarray:
    """(W, 8) int32 word records of the kernel for a tile
    (``csrc/x_sweep.cu``): :func:`word_table`'s five columns, then each
    word in the register coordinates of its phase and the phase's
    register vectors.

    Phases cut the list, in order, into runs of consecutive words whose
    flip bits (in tile coordinates) together span at most REG_BITS bits;
    each phase's register vectors are those bits, padded with the lowest
    other tile bits (and with zero vectors in a tile of fewer than
    REG_BITS bits).  A word that flips more than REG_BITS bits makes a
    phase of its own, whose vectors are its whole x (pivot: its lowest
    bit) and REG_BITS - 1 single bits.  Raises when a word's x is empty or
    leaves the tile."""
    tmask = _tile_mask(tile_bits, n_qubits)
    pos = _bits(tmask)
    tile_of = {q: i for i, q in enumerate(pos)}

    def to_tile(m: int) -> int:
        return sum(1 << tile_of[q] for q in _bits(m) if q in tile_of)

    xts = []
    for _, xm, _, _ in words:
        if xm <= 0 or xm & ~tmask:
            raise ValueError(f"x_mask {xm:#x} is empty or leaves the tile "
                             f"{tmask:#x}")
        xts.append(to_tile(xm))
    phases = []                      # [first word, pivots, wide x or 0]
    for w, xt in enumerate(xts):
        if _popcount(xt) > REG_BITS:
            phases.append([w, xt & -xt, xt])
        elif (phases and not phases[-1][2]
              and _popcount(phases[-1][1] | xt) <= REG_BITS):
            phases[-1][1] |= xt
        else:
            phases.append([w, xt, 0])

    table = np.zeros((len(words), 8), np.int32)
    table[:, :5] = word_table(words)
    ends = [p[0] for p in phases[1:]] + [len(words)]
    for (a, reg, wide), b in zip(phases, ends):
        for q in range(len(pos)):
            if _popcount(reg) < REG_BITS:
                reg |= 1 << q
        vecs = [wide if wide and r == wide & -wide else r
                for r in (1 << q for q in _bits(reg))]
        vecs += [0] * (REG_BITS - len(vecs))
        for w in range(a, b):
            zt = to_tile(words[w][2])
            xr = (1 << vecs.index(wide) if wide else
                  sum(1 << i for i, v in enumerate(vecs) if v & xts[w]))
            zr = sum(1 << i for i, v in enumerate(vecs)
                     if _popcount(v & zt) & 1)
            table[w, 5:] = (xr | zr << 4 | (w == a) << 8 | (zt & ~reg) << 16,
                            vecs[0] | vecs[1] << 16, vecs[2] | vecs[3] << 16)
    return table


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_library(
        "x_sweep", [KERNEL_SOURCE],
        [find_nvcc(), "-O3", "-std=c++17",
         "-gencode", "arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])
    p = ctypes.c_void_p
    lib.fgk_x_sweep.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint, p]
    lib.fgk_x_sweep.restype = ctypes.c_int
    i, f = ctypes.c_int, ctypes.c_float
    lib.fgk_x_sweep_phase.argtypes = [p, p, p, p, p, i, i, ctypes.c_uint,
                                      p, p, i, i, p]
    lib.fgk_x_sweep_phase.restype = i
    lib.fgk_phase_collect.argtypes = [p, i, i, f, p, ctypes.c_uint, p, i, p]
    lib.fgk_phase_collect.restype = i
    lib.fgk_phase_classify.argtypes = [p, i, i, f, p, i, p, p, p]
    lib.fgk_phase_classify.restype = i
    return lib


def _checked(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def x_sweep_cuda(re: torch.Tensor, im: torch.Tensor, table: torch.Tensor,
                 n_qubits: int, tile_bits: Union[int, Sequence[int]],
                 phase: Optional[HalfPhase] = None, at: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream of ``re``'s device.

    Takes contiguous CUDA tensors: ``re`` and ``im`` float32
    (2^n_qubits,), 16-byte aligned, and ``table`` int32 (W, 8) from
    :func:`sweep_table` for the same tile, W <= MAX_WORDS.  ``tile_bits``
    is a count T (the contiguous tile, bits 0..T-1) or the tile's bit
    positions.  ``at`` (PHASE_LOAD, PHASE_STORE or both) applies
    ``phase``, a :class:`HalfPhase` on the same device, after the load or
    before the store; ``at = 0`` is the sweep alone.
    Returns new (re, im) tensors.
    """
    tmask = _tile_mask(tile_bits, n_qubits)
    dim = 1 << n_qubits
    checks = [("re", re, torch.float32, (dim,)),
              ("im", im, torch.float32, (dim,)),
              ("table", table, torch.int32, (table.shape[0], 8))]
    if at:
        if at not in (PHASE_LOAD, PHASE_STORE, PHASE_LOAD | PHASE_STORE):
            raise ValueError(f"at={at}: PHASE_LOAD, PHASE_STORE or both")
        if phase is None:
            raise ValueError(f"at={at} needs a phase")
        classes = phase.table.shape[0]
        if not 1 <= classes <= MAX_PHASE_CLASSES:
            raise ValueError(f"phase of {classes} classes, past "
                             f"{MAX_PHASE_CLASSES}")
        checks += [("phase.cls", phase.cls, torch.uint8, (dim,)),
                   ("phase.table", phase.table, torch.float32,
                    (classes, 2))]
    for name, t, dtype, shape in checks:
        if t.device != re.device or t.device.type != "cuda":
            raise ValueError(f"{name} must lie on re's CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("re and im must start 16-byte aligned (the kernel "
                         "moves them with 16-byte loads)")
    if table.shape[0] > MAX_WORDS:
        raise ValueError(f"table of {table.shape[0]} words: one launch "
                         f"takes at most {MAX_WORDS}")
    lib = _library()
    re_out = torch.empty_like(re)
    im_out = torch.empty_like(im)
    args = (re.data_ptr(), im.data_ptr(), re_out.data_ptr(),
            im_out.data_ptr(), table.data_ptr(), table.shape[0], n_qubits,
            tmask)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        if at:
            rc = lib.fgk_x_sweep_phase(
                *args, phase.cls.data_ptr(), phase.table.data_ptr(),
                phase.table.shape[0], at, stream)
        else:
            rc = lib.fgk_x_sweep(*args, stream)
    if rc != 0:
        raise RuntimeError(f"x_sweep kernel launch failed: cudaError {rc}")
    x_sweep_cuda.launches += 1
    if at:
        count("trotter.phase_launches")
    return re_out, im_out


x_sweep_cuda.launches = 0


def _tile_sweep(n_qubits: int, seq: List[Word],
                tile_bits: Union[int, Sequence[int]]) -> Callable:
    """``(re, im, phase=None, at=0) -> (re, im)`` applying ``seq`` in
    order inside one tile, with the half-phase at the ends ``at`` names:
    the kernel on a CUDA tensor, the plain version on a CPU tensor.  The
    kernel's records are built here, so a tile or word the kernel cannot
    take raises on every device (:func:`sweep_table`)."""
    table = sweep_table(seq, n_qubits, tile_bits)
    on_device = {}

    def sweep(re: torch.Tensor, im: torch.Tensor,
              phase: Optional[HalfPhase] = None, at: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        if re.device.type == "cuda":
            t = on_device.get(re.device)
            if t is None:
                t = on_device[re.device] = torch.as_tensor(
                    table, device=re.device)
            return x_sweep_cuda(re, im, t, n_qubits, tile_bits, phase, at)
        if re.device.type == "cpu":
            return x_sweep_reference(re, im, seq, n_qubits, phase, at)
        raise ValueError(f"no x_sweep for device {re.device}")

    return sweep


def make_x_sweep(n_qubits: int, words: Sequence[Word],
                 tile_bits: int = TILE_BITS, reverse: bool = False
                 ) -> Optional[Callable]:
    """A callable ``(re, im) -> (re, im)`` applying exp(-i theta P) for
    every word (theta, x_mask, z_mask, n_y) in order (reversed when
    ``reverse``), every x_mask inside the contiguous tile of
    2^min(tile_bits, n_qubits) amplitudes.

    Returns None when a word's x_mask is <= 0 or leaves the tile.  The
    callable launches the kernel for tensors on a CUDA device and runs
    :func:`x_sweep_reference` for tensors on the CPU.
    """
    tile_bits = min(tile_bits, n_qubits)
    if any(w[1] <= 0 or w[1] >= 1 << tile_bits for w in words):
        return None
    seq = list(reversed(words)) if reverse else list(words)
    return _tile_sweep(n_qubits, seq, tile_bits)


def plan_sweeps(words: Sequence[Word], n_qubits: int,
                tile_bits: int = TILE_BITS
                ) -> List[Tuple[Tuple[int, ...], List[Word]]]:
    """Cut an ordered word list into consecutive groups, in order, each
    inside one gathered tile: (tile bit positions, words).

    A group grows, up to MAX_WORDS words, while the union of its words'
    flip bits and the lowest LOW_BITS bits spans at most
    T = min(tile_bits, n_qubits) bits; the tile is that union filled up
    to T bits with the lowest other bits (a word that flips more than
    T - LOW_BITS high bits starts a tile without them).  Word order is
    never changed, so applying the groups one after another is the
    word-by-word product.  Raises, on every device, for a word no tile
    holds: no flip bit, a bit at or above n_qubits, or more than T flip
    bits."""
    t = min(tile_bits, n_qubits)
    low = (1 << min(LOW_BITS, t)) - 1
    groups: List[list] = []          # [tile mask, words]
    for w in words:
        xm = w[1]
        if xm <= 0 or xm >> n_qubits or _popcount(xm) > t:
            raise ValueError(f"x_mask {xm:#x} fits no {t}-bit tile of "
                             f"{n_qubits} qubits")
        if (groups and len(groups[-1][1]) < MAX_WORDS
                and _popcount(groups[-1][0] | xm) <= t):
            groups[-1][0] |= xm
            groups[-1][1].append(w)
        else:
            groups.append([low | xm if _popcount(low | xm) <= t else xm,
                           [w]])
    plan = []
    for mask, ws in groups:
        for q in range(n_qubits):
            if _popcount(mask) < t:
                mask |= 1 << q
        plan.append((tuple(_bits(mask)), ws))
    return plan


def make_gathered_sweeps(n_qubits: int, words: Sequence[Word],
                         tile_bits: int = TILE_BITS) -> Callable:
    """``(re, im) -> (re, im)`` applying ``words`` in order through the
    groups of :func:`plan_sweeps`: one kernel launch a group on a CUDA
    tensor, the plain version (the same chain of
    :func:`_pauli_rotation_pair`) on a CPU tensor.  Its ``steps`` are the
    groups' sweeps, each ``(re, im, phase=None, at=0) -> (re, im)``."""
    steps = [_tile_sweep(n_qubits, ws, tile)
             for tile, ws in plan_sweeps(words, n_qubits, tile_bits)]

    def sweeps(re: torch.Tensor, im: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        for step in steps:
            re, im = step(re, im)
        return re, im

    sweeps.steps = steps
    return sweeps
