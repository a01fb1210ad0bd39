"""gnark_tpu_torch.stats against the golden constraint counts that
gnark_tpu's own test reads (tests/test_stats.py): every snippet over the
port's six curves under both schemes, and ``python -m
gnark_tpu_torch.stats`` prints the golden file's JSON.

Tolerance: none; the counts compare exactly.
"""

import json
import os
import pathlib
import subprocess
import sys

from gnark_tpu_torch import stats
from gnark_tpu_torch.curves import ALL_CURVES

GOLDEN = pathlib.Path(__file__).parent / "stats_golden.json"
REPO = str(pathlib.Path(__file__).parent.parent)


def test_snippet_counts_match_golden():
    golden = json.loads(GOLDEN.read_text())
    assert stats.all_stats(list(ALL_CURVES.values())) == golden


def test_main_prints_the_golden_file():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "gnark_tpu_torch.stats"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == json.loads(GOLDEN.read_text())
