"""The port's star-POA merge micro-benchmark (native/bench/poa_bench.cpp)
builds from the port's own native sources (native/loader.build_poa_bench,
into the gitignored native/build/) and runs: `RT_POA_PROF=1 poa_bench 4 4
1` exits 0 and prints its summary line and each merge phase's time."""

import os
import re
import subprocess

from racon_tpu_torch.native import loader


def test_poa_bench_builds_and_prints_each_phase():
    path = loader.build_poa_bench()
    assert path is not None and os.access(path, os.X_OK)
    assert os.path.dirname(path) == loader.BUILD_DIR
    assert loader.build_poa_bench() == path  # built once, then reused
    res = subprocess.run([path, "4", "4", "1"], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, RT_POA_PROF="1"))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert re.fullmatch(r"4 windows x 1 rounds x depth 4: [0-9.]+ s "
                        r"\([0-9]+ w-rounds/s\)", lines[0]), lines
    phases = re.fullmatch(r"build ([0-9.]+) ms  bundle ([0-9.]+) ms  "
                          r"emit ([0-9.]+) ms", lines[1])
    assert phases, lines
    # RT_POA_PROF=1 turns the phase clocks on: the merge took some time
    assert sum(float(x) for x in phases.groups()) > 0
