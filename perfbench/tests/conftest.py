"""The small configuration of every cell the manifest has, for the
CPU runs of ``small.py``: cells added after it name theirs here."""

from perfbench.tests import small

small.SMALL.setdefault("n2-ccpvdz", "perfbench/tests/data/h2o-sci-skqd.json")
