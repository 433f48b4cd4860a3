"""The port's measurement tools (``flow_guided_krylov_torch/tools/``) on
the CPU, at small sizes: what they count and compute, not their times
(off the card every timing field is None)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flow_guided_krylov_torch.chem.ccsd import run_ccsd
from flow_guided_krylov_torch.hamiltonians.molecular import (
    create_lih_hamiltonian, create_synthetic_hamiltonian)
from flow_guided_krylov_torch.ops.bits import to_device
from flow_guided_krylov_torch.tools import (ccsd_bar, random_determinants,
                                            repro_pt2_block,
                                            roofline_connection,
                                            sharded_scaling, system)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOOLS = ("roofline_connection", "repro_pt2_block", "sharded_scaling",
         "ccsd_bar")


@pytest.fixture(autouse=True)
def _integral_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path / "integrals"))


@pytest.mark.parametrize("shape", [(6, 2, 2), (10, 7, 7), (33, 1, 1)],
                         ids=["6:2", "10:7", "33:1 (W=4)"])
def test_roofline_bytes_are_the_outputs_nbytes(shape):
    h = create_synthetic_hamiltonian(*shape, "cpu")
    rows = random_determinants(h, 40, seed=1)
    conn, el = h.connections_device(to_device(rows, "cpu"))
    a = roofline_connection.analytic(h, len(rows))
    assert a["output_bytes"] == conn.nbytes + el.nbytes
    assert a["connections"] == conn.shape[0] * conn.shape[1]
    assert sum(a["sections"].values()) == a["C"] == h.n_connections
    assert a["W"] == h.pack_words and a["bound_by"] == "bytes"
    assert len(np.unique(h.keys(rows))) == len(rows)


def test_roofline_ablations_keep_the_production_outputs():
    """The ablation harness runs on the production sections: the one-chunk
    call and the variants that keep an output write what the production
    call writes; no time is taken off the card."""
    h = create_lih_hamiltonian("cpu")
    rows = to_device(h.enumerate_basis(), "cpu")
    variants, chunk = roofline_connection._variants(h, torch.device("cpu"))
    conn, el = variants["full"](rows)
    one_conn, one_el = variants["one_chunk"](rows)
    assert torch.equal(conn, one_conn) and torch.equal(el, one_el)
    kept_conn, _, _ = variants["no_elem_write"](rows)
    _, kept_el, _ = variants["no_conn_write"](rows)
    assert torch.equal(kept_conn, conn) and torch.equal(kept_el, el)
    no_par = variants["no_parity"](rows)[1]
    assert torch.equal(no_par.abs(), el.abs())
    m = roofline_connection.measure(h, h.enumerate_basis(), "cpu", reps=1)
    assert set(m["variants"]) == set(variants)
    assert all(v["ms"] is None and v["launches"] is None
               for v in m["variants"].values())


def test_repro_pt2_block_returns_the_expanders_block():
    h = system("n2_ccpvdz", "cpu")
    r = repro_pt2_block.run_block(h, 64, iters=1)
    src, c = repro_pt2_block.sources(h, 64)
    cand, coup = repro_pt2_block.expander(h)._pt2_topk_device(src, c)
    np.testing.assert_array_equal(r["cand"], cand)
    np.testing.assert_array_equal(r["coupling"], coup)
    assert r["elements"] == 64 * 2835 and r["ms"] is None
    rows = repro_pt2_block.sweep(h, rows_list=(64,), reps=1)
    assert rows[0]["top_overlap"] == 1.0 and rows[0]["device_ms"] is None


def test_ccsd_bar_prints_the_ccsd_energy():
    out = subprocess.run(
        [sys.executable, "-m", "flow_guided_krylov_torch.tools.ccsd_bar",
         "--system", "h2", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cc = run_ccsd(system("h2", "cpu").integrals, do_triples=True)
    assert got["ccsd_energy"] == cc.e_tot
    assert got["ccsd_t_energy"] == cc.e_tot_t
    assert got["ccsd_converged"] and got["system"] == "h2"
    assert got == {**ccsd_bar.ccsd_bar("h2", "cpu"),
                   "wall_s": got["wall_s"]}


def test_sharded_scaling_runs_on_a_cpu_mesh(monkeypatch):
    """With the single card on the mesh's word list the sharded evolve
    equals it bit for bit; on its own list (TFIM's commuting X's once at
    full angle) the tool holds it to ``EVOLVE_ATOL``."""
    from flow_guided_krylov_torch.krylov import skqd
    with monkeypatch.context() as m:
        m.setattr(skqd, "_substep_words", lambda offd, dt: (
            skqd._half_angle_words(offd, dt), False))
        rows = sharded_scaling.scaling("cpu", sites=10, molecule="lih",
                                       reps=1, entries=(1, 2))
    assert [r["entries"] for r in rows] == [1, 2]
    assert rows[1]["layout"] == "2 x cpu"
    assert all(r["evolve_gap"] == 0.0 and r["matvec_rel_gap"] == 0.0
               and r["trotter_evolve_ms"] is None for r in rows)
    rows = sharded_scaling.scaling("cpu", sites=10, molecule="lih", reps=1,
                                   entries=(1, 2))
    assert rows[1]["evolve_gap"] <= sharded_scaling.EVOLVE_ATOL


@pytest.mark.parametrize("name", TOOLS)
def test_tool_without_a_card_raises(name):
    """``--device cuda`` (the default) without a card raises before any
    work: nothing falls back to the CPU."""
    import importlib
    mod = importlib.import_module("flow_guided_krylov_torch.tools." + name)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(["--system", "h2"] if name in ("ccsd_bar",
                                                "repro_pt2_block") else [])
