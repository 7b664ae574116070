"""The comparison that decides ``correct`` fails what it must: a run of
the harness on the CPU at the configuration's own widths, with the timed
path broken underneath (``benchmark/faults.py``), comes out not correct
for each fault a P-frame cell can have: a step that returns its state
unchanged, half of the batch left out (its outputs stood in for by the
rest's), a decoded frame altered where it is produced, and the rate
altered where it is produced (the hyper latent's bits left out, the
sigma floor removed). The same run with nothing broken comes out correct,
and the control (the program's int8 path) comes out not correct."""

from __future__ import annotations

import copy
import time

import pytest

from benchmark.faults import FAULTS
from benchmark.harness import cell, spec
from benchmark.tests.helpers import config_file, few_threads

BENCH = spec.load_spec()
#: full widths, a small frame, two streams, GOPs of four
FRAME = {"height": 256, "width": 256}


def setting():
    cfg = copy.deepcopy(config_file("dmc-perf-1080p-bf16"))
    cfg["frame"] = dict(FRAME)
    traffic = dict(spec.traffic("bulk-b4-gop8"), streams=2, group=4,
                   sample_from=1)
    return cfg, traffic


def run(wrap=None, control=None, seed=2 ** 31 + 99):
    few_threads()
    cfg, traffic = setting()
    return cell.run("pframe-bulk-b4", seed, 0.1, False,
                    t_start=time.perf_counter(), device="cpu", bench=BENCH,
                    config=cfg, traffic=traffic, wrap=wrap, control=control)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault):
    r = run(FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_control_is_caught():
    r = run(control="int8")
    assert not r["correct"], r["checks"]
