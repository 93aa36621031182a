"""Execute every examples/ script as a module, so a signature drift in the
packed or diff surface cannot break examples/serving.py / advanced.py
silently.

Slow tier: the scripts take seconds to about a minute and a half each on
the CPU.  Each runs in a SUBPROCESS with the platform forced to cpu the same
way tests/conftest.py does, so a hang or crash in one example cannot take
down the suite process.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*.py"))


def test_examples_inventory():
    """The parametrized list below must actually cover examples/ (a new
    example auto-joins; an empty glob would silently skip everything)."""
    assert {p.stem for p in EXAMPLES} >= {"pendulum", "serving", "iiwa_batch",
                                          "advanced"}


@pytest.mark.slow
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs(path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            f"import runpy; runpy.run_path({str(path)!r}, "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, (
        f"{path.name} exited {out.returncode}\n--- stdout:\n"
        f"{out.stdout[-2000:]}\n--- stderr:\n{out.stderr[-2000:]}")
