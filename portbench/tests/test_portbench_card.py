"""On the card: one short run of a cell through the command as the
benchmark's runs call it. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sf1.fof_distinct", "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
