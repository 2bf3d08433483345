"""The port's CLI on one card, variants timed in turns:

    python -m racon_tpu_torch.benchmarks.cli_ab [--genome-mb 4.6]
        [--rounds 2] [--json PATH] NAME=SRC[:KEY=VALUE...] ...

Each variant runs `python -m racon_tpu_torch.cli --backend cuda -m 5 -x -4
-g -8 -t <cores>` from the source tree SRC ("." is this checkout; another
version can be unpacked there with `git archive <commit> | tar -x`), with
the environment variables KEY=VALUE set, on chip_smoke.py phase 4's
dataset (testing.synth.make_dataset: genome_mb, 20x 8 kb reads, 12 %
error, seed 11). Each variant first runs once, untimed, on a 50 kb
dataset (its kernel and native builds); then each round runs the
variants in order and again in reverse (A B B A). Per run: the
process's wall time and the logger's initialize and polish seconds (the
sums of its "[racon::Polisher::initialize]" and "...::polish]" lines on
stderr); every run's FASTA must be the same. Prints the card's name and
power limit first and one JSON line last. Needs a CUDA device (exit 2
without one).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ARGV = ["--backend", "cuda", "-m", "5", "-x", "-4", "-g", "-8"]
_STAGE = re.compile(r"\[racon::Polisher::(initialize|polish)\] .*?"
                    r"([0-9.]+) s$")


def parse_variant(text: str) -> tuple[str, str, dict]:
    """NAME=SRC[:KEY=VALUE...] -> (name, absolute source dir, env)."""
    name, _, rest = text.partition("=")
    src, *pairs = rest.split(":")
    if not name or not src or any("=" not in p for p in pairs):
        raise ValueError(f"bad variant {text!r}: NAME=SRC[:KEY=VALUE...]")
    return name, os.path.abspath(src), dict(p.split("=", 1) for p in pairs)


def stage_seconds(stderr: str) -> dict:
    """Seconds per stage from the logger's lines on stderr."""
    out = {"initialize": 0.0, "polish": 0.0}
    for line in re.split(r"[\r\n]", stderr):
        m = _STAGE.search(line.strip())
        if m:
            out[m.group(1)] += float(m.group(2))
    return out


def run(src: str, env: dict, inputs: list[str]) -> dict:
    """One CLI run from `src` with `env`: wall s, stage s, FASTA sha256."""
    full = {**os.environ, **env, "PYTHONPATH": src}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", *ARGV, "-t",
         str(os.cpu_count() or 8), *inputs], cwd=src, env=full,
        capture_output=True, timeout=1200)
    wall = time.perf_counter() - t0
    if res.returncode:
        raise RuntimeError(f"{src} {env} exited {res.returncode}: "
                           f"{res.stderr.decode()[-2000:]}")
    return dict(wall_s=wall, **{f"{k}_s": v for k, v in
                                stage_seconds(res.stderr.decode()).items()},
                sha256=hashlib.sha256(res.stdout).hexdigest())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--genome-mb", type=float, default=4.6)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("cli_ab: no CUDA device\n")
        return 2
    from racon_tpu_torch.testing.synth import make_dataset

    variants = [parse_variant(v) for v in args.variants]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as small, \
            tempfile.TemporaryDirectory() as wd:
        make_dataset(small, 50_000, 8000, 20, 0.12, seed=11)
        make_dataset(wd, int(args.genome_mb * 1e6), 8000, 20, 0.12, seed=11)
        files = ("reads.fasta", "ovl.paf", "draft.fasta")
        for name, src, env in variants:
            run(src, env, [os.path.join(small, f) for f in files])
        order = variants + variants[::-1]
        for r in range(args.rounds):
            for name, src, env in order:
                res = dict(variant=name, round=r, **run(
                    src, env, [os.path.join(wd, f) for f in files]))
                runs.append(res)
                print(json.dumps(res), flush=True)
    shas = {r["sha256"] for r in runs}
    summary = {}
    for name, _, _ in variants:
        mine = [r for r in runs if r["variant"] == name]
        summary[name] = {k: [round(r[k], 3) for r in mine]
                         for k in ("wall_s", "initialize_s", "polish_s")}
    out = dict(genome_mb=args.genome_mb, runs=runs, summary=summary,
               fasta_equal=len(shas) == 1)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(dict(summary=summary, fasta_equal=len(shas) == 1)))
    return 0 if len(shas) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
