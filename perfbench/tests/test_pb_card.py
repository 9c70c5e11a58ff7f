"""A short run of every cell on the card: the result line's keys, the
device it names, and `correct`. Skips without a card; run on the card with

    python -m pytest perfbench/tests/test_pb_card.py -q
"""

import json
import subprocess
import sys

import pytest

from pbcore import manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    r = subprocess.run([sys.executable, str(manifest.BENCH_DIR / "run.py"), "--workload", cell,
                        "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=manifest.REPO, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["correct"], result["checks"]
