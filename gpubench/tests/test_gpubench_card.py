"""The comparison that decides ``correct``, held to its control and to
planted faults on the card, at each cell's own size (a short window at
the cell's own load).  They skip without a card; on the chip:

    python3 -m pytest gpubench/tests/test_gpubench_card.py -q
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SECONDS = 8.0


def _kind(cell):
    from gpubench import run

    return run.cell_spec(BENCH, cell)[3]["workload"]["kind"]


@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
@pytest.mark.parametrize("cell", CELLS)
def test_gpubench_control_is_not_correct(card, cell, seed):
    """The fp8 reference in the program's place, and the served values
    rounded to float32: one of the cell's numbers over its limit."""

    from gpubench import control, run

    keep = {}
    result = run.run_cell(BENCH, cell, seed, SECONDS, 0, keep=keep)
    assert result["correct"], result["compared"]
    limits = run.cell_spec(BENCH, cell)[3]["limits"]
    got = control.control_numbers(keep["run"])
    over = [k for k, v in got.items() if k in limits and v > limits[k]]
    assert over, got
    assert got["merge_mismatches"] > limits["merge_mismatches"]
    assert got["scrapes_not_served"] == 0


def _faults(cell):
    from gpubench import kinds

    return kinds.load(_kind(cell)).FAULTS


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in _faults(c)])
def test_gpubench_planted_fault_is_not_correct(card, cell, fault):
    from gpubench import run

    result = run.run_cell(BENCH, cell, 2 ** 31 + 201, SECONDS, 0,
                          fault=fault)
    assert not result["correct"], result["compared"]
