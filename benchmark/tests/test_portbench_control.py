"""The controls behind the limits, at small widths on the CPU (on the card
`python3 benchmark/control.py` reads them at the cells' own sizes): the
reference at the precision below the configuration's, in the program's place,
and each fault come out not correct against the cell's limits, while a sound
run of the program comes out correct."""

import portbench_small as small
import pytest

import control


@pytest.mark.parametrize("cell", ["mmf_m4c.train_xe", "mmf_m4c.eval_greedy"])
def test_the_control_and_each_fault_come_out_not_correct(cell):
    sound = small.run(cell)
    assert sound["correct"], sound["checks"]
    reading, = control.control(cell, [small.SEED], "cpu", small.config(cell), small.TRAFFIC)
    faults = [label for label in reading if label not in ("workload", "seed",
                                                          "stated_precision")]
    assert "control" in faults and len(faults) >= 2
    for label in faults:
        assert reading[label]["correct"] is False, (label, reading[label]["checks"])
    if "stated_precision" in reading:  # the witness: rounding the program has too
        assert reading["stated_precision"]["correct"], reading["stated_precision"]["checks"]
