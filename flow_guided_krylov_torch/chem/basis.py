"""Gaussian basis-set data for the host-side chemistry front end.

The original PyTorch system (its ``hamiltonians/molecular.py:945-1003``)
delegates integrals to PySCF.  This rebuild is self-contained: STO-3G is
generated from the universal least-squares STO-nG primitive fits of
Hehre/Stewart/Pople (JCP 51, 2657 (1969)) scaled by the standard molecular
Slater exponents, which reproduces the published STO-3G tables exactly for
the first row.  6-31G data for H/C/N/O is tabulated directly.

Shells are stored as ``Shell(l, exps, coefs, center)`` with ``l`` in
{0 (s), 1 (p)}.  Contraction coefficients refer to *normalized* primitives;
an overall contracted renormalization is applied by the integral engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

ANGSTROM_TO_BOHR = 1.0 / 0.52917720859  # CODATA-2006, matches PySCF default

ATOMIC_NUMBER: Dict[str, int] = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5,
    "C": 6, "N": 7, "O": 8, "F": 9, "Ne": 10,
    "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "Cr": 24, "Fe": 26,
}

# Universal STO-3G primitive fits for Slater exponent zeta = 1.
# (exponent, coefficient) pairs; exponents scale as alpha * zeta**2.
_STO3G_1S = (
    np.array([2.227660584, 0.405771156, 0.109818]),
    np.array([0.154328967, 0.535328142, 0.444634542]),
)
_STO3G_2SP_EXP = np.array([0.994203, 0.231031, 0.0751386])
_STO3G_2S_COEF = np.array([-0.09996723, 0.39951283, 0.70011547])
_STO3G_2P_COEF = np.array([0.15591627, 0.60768372, 0.39195739])

# 3sp universal fit (zeta = 1), rederived in-repo by the same shared-exponent
# least-squares procedure that reproduces the published 1s/2sp fits to six
# decimals (see tests/test_chem.py); scales as alpha * zeta^2 like the rest.
_STO3G_3SP_EXP = np.array([0.4828543, 0.1347151, 0.0527266])
_STO3G_3S_COEF = np.array([-0.2196200, 0.2255950, 0.9003990])
_STO3G_3P_COEF = np.array([0.0105880, 0.5951670, 0.4620010])

# 3d and 4sp universal fits (zeta = 1), derived by tools/fit_sto3g.py —
# the same overlap-maximizing procedure, validated there against the
# published 1s/2sp fits.  Used for the transition-metal shells.
_STO3G_3D_EXP = np.array([0.52291129, 0.16395960, 0.06386630])
_STO3G_3D_COEF = np.array([0.16865958, 0.58479849, 0.40567798])
_STO3G_4SP_EXP = np.array([0.24645600, 0.09095845, 0.04016816])
_STO3G_4S_COEF = np.array([-0.30884819, 0.01961578, 1.13102933])
_STO3G_4P_COEF = np.array([-0.12154792, 0.57152663, 0.54989234])

# Transition metals: (zeta_1s, zeta_2sp, zeta_3sp, zeta_3d, zeta_4sp).
# No published 3d-metal STO-3G tables are available in-repo; the zetas are
# variational optima of the in-repo atomic ROHF (tools/fit_tm_zeta.py) —
# Fe for Fe2+ (d^6, the Fe-porphyrin oxidation state; 4sp from Slater
# rules), Cr for the neutral 7S atom (3d^5 4s^1, E_ROHF = -1032.5643 Ha).
# The integral engine + ROHF are themselves validated against published
# HF-limit energies via an even-tempered basis (tools/hf_limit_check.py,
# tests/test_chem.py), so these minimal-basis energies sit a documented
# distance above literature values.
_STO3G_ZETA_TM: Dict[str, Tuple[float, float, float, float, float]] = {
    "Cr": (23.5160, 9.6969, 3.9547, 3.4039, 1.2591),
    "Fe": (25.4984, 10.6556, 4.3201, 3.7146, 1.36),
}

# Standard molecular Slater exponents (zeta_1s, zeta_2sp) used by STO-3G.
_STO3G_ZETA: Dict[str, Tuple[float, float]] = {
    "H": (1.24, 0.0),
    "He": (1.69, 0.0),
    "Li": (2.69, 0.80),
    "Be": (3.68, 1.15),
    "B": (4.68, 1.50),
    "C": (5.67, 1.72),
    "N": (6.67, 1.95),
    "O": (7.66, 2.25),
    "F": (8.65, 2.55),
    "Ne": (9.64, 2.88),
}

# Second row: published standard-molecular Slater exponents
# (zeta_1s, zeta_2sp, zeta_3sp) of Hehre, Ditchfield, Stewart, Pople,
# JCP 52, 2769 (1970).  Validated in-repo by reproducing the published
# STO-3G atomic ROHF energies to ~1e-6 Ha (tests/test_chem.py):
# Na -159.668210, Mg -197.007353, Al -238.858356, Si -285.466209,
# P -336.868767, S -393.130217, Cl -454.542190.
_STO3G_ZETA_ROW2: Dict[str, Tuple[float, float, float]] = {
    "Na": (10.61, 3.48, 1.75),
    "Mg": (11.59, 3.90, 1.70),
    "Al": (12.56, 4.36, 1.70),
    "Si": (13.53, 4.83, 1.75),
    "P": (14.50, 5.31, 1.90),
    "S": (15.47, 5.79, 2.05),
    "Cl": (16.43, 6.26, 2.10),
    # Ar: zeta pattern-extrapolated (z2 += 0.48/element); no published
    # atomic-energy cross-check was available in-repo
    "Ar": (17.40, 6.74, 2.35),
}

# 6-31G tabulated data: element -> list of (l, exps, coefs) in a.u.
_631G: Dict[str, List[Tuple[int, Sequence[float], Sequence[float]]]] = {
    "H": [
        (0, [18.7311370, 2.8253937, 0.6401217],
            [0.03349460, 0.23472695, 0.81375733]),
        (0, [0.1612778], [1.0]),
    ],
    "Li": [
        (0, [642.41892, 96.798515, 22.091121, 6.2010703, 1.9351177,
             0.6367358],
            [0.0021426, 0.0162089, 0.0773156, 0.2457860, 0.4701890,
             0.3454708]),
        (0, [2.3249184, 0.6324306, 0.0790534],
            [-0.0350917, -0.1912328, 1.0839878]),
        (1, [2.3249184, 0.6324306, 0.0790534],
            [0.0089415, 0.1410095, 0.9453637]),
        (0, [0.0359620], [1.0]),
        (1, [0.0359620], [1.0]),
    ],
    "F": [
        (0, [7001.7130900, 1051.3660900, 239.2856900, 67.3974453,
             21.5199573, 7.3556160],
            [0.0018196169, 0.0139160796, 0.0684053245, 0.2331857600,
             0.4712674390, 0.3566185460]),
        (0, [20.8479528, 4.8083083, 1.3440699],
            [-0.1085069750, -0.1464516580, 1.1286885800]),
        (1, [20.8479528, 4.8083083, 1.3440699],
            [0.0716287243, 0.3459121030, 0.7224699570]),
        (0, [0.3581514], [1.0]),
        (1, [0.3581514], [1.0]),
    ],
    "C": [
        (0, [3047.5249, 457.36951, 103.94869, 29.210155, 9.2866630, 3.1639270],
            [0.0018347, 0.0140373, 0.0688426, 0.2321844, 0.4679413, 0.3623120]),
        (0, [7.8682724, 1.8812885, 0.5442493],
            [-0.1193324, -0.1608542, 1.1434564]),
        (1, [7.8682724, 1.8812885, 0.5442493],
            [0.0689991, 0.3164240, 0.7443083]),
        (0, [0.1687144], [1.0]),
        (1, [0.1687144], [1.0]),
    ],
    "N": [
        (0, [4173.5110, 627.45790, 142.90210, 40.234330, 12.820210, 4.3904370],
            [0.0018348, 0.0139950, 0.0685870, 0.2322410, 0.4690700, 0.3604550]),
        (0, [11.626358, 2.7162800, 0.7722180],
            [-0.1149610, -0.1691180, 1.1458520]),
        (1, [11.626358, 2.7162800, 0.7722180],
            [0.0675800, 0.3239070, 0.7408950]),
        (0, [0.2120313], [1.0]),
        (1, [0.2120313], [1.0]),
    ],
    "O": [
        (0, [5484.6717, 825.23495, 188.04696, 52.964500, 16.897570, 5.7996353],
            [0.0018311, 0.0139501, 0.0684451, 0.2327143, 0.4701930, 0.3585209]),
        (0, [15.539616, 3.5999336, 1.0137618],
            [-0.1107775, -0.1480263, 1.1307670]),
        (1, [15.539616, 3.5999336, 1.0137618],
            [0.0708743, 0.3397528, 0.7271586]),
        (0, [0.2700058], [1.0]),
        (1, [0.2700058], [1.0]),
    ],
}


# cc-pVDZ (Dunning, JCP 90, 1007 (1989)): element -> (l, exps, coefs).
# Published convention is SPHERICAL harmonics (5 d functions); the integral
# engine builds Cartesians and scf.py projects d shells onto the real
# solid-harmonic combinations.
_CCPVDZ: Dict[str, List[Tuple[int, Sequence[float], Sequence[float]]]] = {
    "H": [
        (0, [13.0100, 1.9620, 0.4446], [0.0196850, 0.1379770, 0.4781480]),
        (0, [0.1220], [1.0]),
        (1, [0.7270], [1.0]),
    ],
    "C": [
        (0, [6665.0, 1000.0, 228.0, 64.71, 21.06, 7.495, 2.797, 0.5215],
            [0.0006920, 0.0053290, 0.0270770, 0.1017180, 0.2747400,
             0.4485640, 0.2850740, 0.0152040]),
        (0, [6665.0, 1000.0, 228.0, 64.71, 21.06, 7.495, 2.797, 0.5215],
            [-0.0001460, -0.0011540, -0.0057250, -0.0233120, -0.0639550,
             -0.1499810, -0.1272620, 0.5445290]),
        (0, [0.1596], [1.0]),
        (1, [9.439, 2.002, 0.5456], [0.0381090, 0.2094800, 0.5085570]),
        (1, [0.1517], [1.0]),
        (2, [0.5500], [1.0]),
    ],
    "N": [
        (0, [9046.0, 1357.0, 309.3, 87.73, 28.56, 10.21, 3.838, 0.7466],
            [0.0007000, 0.0053890, 0.0274060, 0.1032070, 0.2787230,
             0.4485400, 0.2782380, 0.0154400]),
        (0, [9046.0, 1357.0, 309.3, 87.73, 28.56, 10.21, 3.838, 0.7466],
            [-0.0001530, -0.0012080, -0.0059920, -0.0245440, -0.0674590,
             -0.1580780, -0.1218310, 0.5490030]),
        (0, [0.2248], [1.0]),
        (1, [13.55, 2.917, 0.7973], [0.0399190, 0.2171690, 0.5103190]),
        (1, [0.2185], [1.0]),
        (2, [0.8170], [1.0]),
    ],
    "O": [
        (0, [11720.0, 1759.0, 400.8, 113.7, 37.03, 13.27, 5.025, 1.013],
            [0.0007100, 0.0054700, 0.0278370, 0.1048000, 0.2830620,
             0.4487190, 0.2709520, 0.0154580]),
        (0, [11720.0, 1759.0, 400.8, 113.7, 37.03, 13.27, 5.025, 1.013],
            [-0.0001600, -0.0012630, -0.0062670, -0.0257160, -0.0709240,
             -0.1654110, -0.1169550, 0.5573680]),
        (0, [0.3023], [1.0]),
        (1, [17.70, 3.854, 1.046], [0.0430180, 0.2289130, 0.5087280]),
        (1, [0.2753], [1.0]),
        (2, [1.1850], [1.0]),
    ],
    "F": [
        (0, [14710.0, 2207.0, 502.8, 142.6, 46.47, 16.70, 6.356, 1.316],
            [0.0007210, 0.0055530, 0.0282670, 0.1064440, 0.2868140,
             0.4486410, 0.2647610, 0.0153330]),
        (0, [14710.0, 2207.0, 502.8, 142.6, 46.47, 16.70, 6.356, 1.316],
            [-0.0001650, -0.0013080, -0.0064950, -0.0266910, -0.0736900,
             -0.1707760, -0.1123270, 0.5628140]),
        (0, [0.3897], [1.0]),
        (1, [22.67, 4.977, 1.347], [0.0448780, 0.2357180, 0.5085210]),
        (1, [0.3471], [1.0]),
        (2, [1.6400], [1.0]),
    ],
}

# basis names whose d shells use the spherical-harmonic (5d) convention
SPHERICAL_BASES = ("cc-pvdz", "ccpvdz")


def is_spherical_basis(basis: str) -> bool:
    return basis.lower().replace("_", "-") in SPHERICAL_BASES


@dataclass
class Shell:
    """A contracted Gaussian shell on one center."""
    l: int                 # angular momentum: 0=s, 1=p
    exps: np.ndarray       # (K,) primitive exponents
    coefs: np.ndarray      # (K,) contraction coefficients (normalized primitives)
    center: np.ndarray     # (3,) position in Bohr

    @property
    def n_functions(self) -> int:
        return 1 if self.l == 0 else 3


def _sto3g_shells(element: str) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    e1s, c1s = _STO3G_1S
    if element in _STO3G_ZETA:
        z1, z2 = _STO3G_ZETA[element]
        shells = [(0, e1s * z1 ** 2, c1s.copy())]
        if z2 > 0.0:
            shells.append((0, _STO3G_2SP_EXP * z2 ** 2, _STO3G_2S_COEF.copy()))
            shells.append((1, _STO3G_2SP_EXP * z2 ** 2, _STO3G_2P_COEF.copy()))
        return shells
    if element in _STO3G_ZETA_ROW2:
        z1, z2, z3 = _STO3G_ZETA_ROW2[element]
        return [
            (0, e1s * z1 ** 2, c1s.copy()),
            (0, _STO3G_2SP_EXP * z2 ** 2, _STO3G_2S_COEF.copy()),
            (1, _STO3G_2SP_EXP * z2 ** 2, _STO3G_2P_COEF.copy()),
            (0, _STO3G_3SP_EXP * z3 ** 2, _STO3G_3S_COEF.copy()),
            (1, _STO3G_3SP_EXP * z3 ** 2, _STO3G_3P_COEF.copy()),
        ]
    if element in _STO3G_ZETA_TM:
        z1, z2, z3, zd, z4 = _STO3G_ZETA_TM[element]
        return [
            (0, e1s * z1 ** 2, c1s.copy()),
            (0, _STO3G_2SP_EXP * z2 ** 2, _STO3G_2S_COEF.copy()),
            (1, _STO3G_2SP_EXP * z2 ** 2, _STO3G_2P_COEF.copy()),
            (0, _STO3G_3SP_EXP * z3 ** 2, _STO3G_3S_COEF.copy()),
            (1, _STO3G_3SP_EXP * z3 ** 2, _STO3G_3P_COEF.copy()),
            (2, _STO3G_3D_EXP * zd ** 2, _STO3G_3D_COEF.copy()),
            (0, _STO3G_4SP_EXP * z4 ** 2, _STO3G_4S_COEF.copy()),
            (1, _STO3G_4SP_EXP * z4 ** 2, _STO3G_4P_COEF.copy()),
        ]
    raise ValueError(
        f"STO-3G data unavailable for element {element!r} "
        f"(supported: {sorted(_STO3G_ZETA) + sorted(_STO3G_ZETA_ROW2)
                       + sorted(_STO3G_ZETA_TM)})")


def build_shells(
    geometry: Sequence[Tuple[str, Tuple[float, float, float]]],
    basis: str = "sto-3g",
) -> List[Shell]:
    """Build the shell list for a geometry given in Angstrom."""
    basis = basis.lower().replace("_", "-")
    shells: List[Shell] = []
    for element, xyz in geometry:
        center = np.asarray(xyz, dtype=np.float64) * ANGSTROM_TO_BOHR
        if basis in ("sto-3g", "sto3g"):
            raw = _sto3g_shells(element)
        elif basis in ("6-31g*", "631g*", "6-31gs", "631gs"):
            if element == "H":
                raw = [(l, np.asarray(e, float), np.asarray(c, float))
                       for l, e, c in _631G["H"]]
            elif element in _631G:
                raw = [(l, np.asarray(e, float), np.asarray(c, float))
                       for l, e, c in _631G[element]]
                # polarization: single Cartesian-d, exponent 0.8 (C/N/O/F)
                raw.append((2, np.array([0.8]), np.array([1.0])))
            else:
                raise ValueError(
                    f"6-31G* data unavailable for element {element!r}")
        elif basis in ("6-31g", "631g"):
            if element not in _631G:
                raise ValueError(
                    f"6-31G data unavailable for element {element!r} "
                    f"(supported: {sorted(_631G)})")
            raw = [(l, np.asarray(e, float), np.asarray(c, float))
                   for l, e, c in _631G[element]]
        elif basis in SPHERICAL_BASES:
            if element not in _CCPVDZ:
                raise ValueError(
                    f"cc-pVDZ data unavailable for element {element!r} "
                    f"(supported: {sorted(_CCPVDZ)})")
            raw = [(l, np.asarray(e, float), np.asarray(c, float))
                   for l, e, c in _CCPVDZ[element]]
        else:
            raise ValueError(f"Unsupported basis {basis!r}")
        for l, exps, coefs in raw:
            shells.append(Shell(l=l, exps=np.asarray(exps, float),
                                coefs=np.asarray(coefs, float), center=center))
    return shells


def nuclear_charges(
    geometry: Sequence[Tuple[str, Tuple[float, float, float]]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (charges (M,), coords_bohr (M, 3)) for the nuclei."""
    charges = np.array([ATOMIC_NUMBER[el] for el, _ in geometry], dtype=np.float64)
    coords = np.array([xyz for _, xyz in geometry], dtype=np.float64)
    return charges, coords * ANGSTROM_TO_BOHR


def nuclear_repulsion(
    geometry: Sequence[Tuple[str, Tuple[float, float, float]]],
) -> float:
    charges, coords = nuclear_charges(geometry)
    e = 0.0
    for i in range(len(charges)):
        for j in range(i + 1, len(charges)):
            e += charges[i] * charges[j] / np.linalg.norm(coords[i] - coords[j])
    return float(e)
