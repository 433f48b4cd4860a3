"""The small configuration of each cell added after
``perfbench/tests/conftest.py``, for the CPU runs of
``perfbench/tests/small.py``."""

from perfbench.tests import small

small.SMALL.setdefault("n2-ccpvdz-10o", "perfbench/tests/data/h2o-table.json")
