"""In a fresh process: the harness and the program it drives pull in no
module whose top-level name is exactly ``jax``, ``jaxlib``, ``flax`` or
``phyx_tpu``; the reference pulls in none of those and not the program."""

import json
import subprocess
import sys

from benchmark.tests.cells import REPO

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        imports=imports)], cwd=REPO, capture_output=True, text=True,
        check=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_leave_jax_out():
    tops = loaded("import benchmark.run, benchmark.trace, benchmark.check\n"
                  "import phyx_tpu_torch.step, phyx_tpu_torch.tune\n"
                  "import phyx_tpu_torch.profiling, torch.profiler")
    assert "phyx_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "phyx_tpu"}


def test_reference_leaves_the_program_out():
    tops = loaded("import benchmark.reference.engine, benchmark.check")
    assert not tops & {"jax", "jaxlib", "flax", "phyx_tpu",
                       "phyx_tpu_torch", "torch"}
