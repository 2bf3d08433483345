"""racon-compatible CLI of the port (console script `raconx-torch`).

Same positional arguments, options, defaults, FASTA-on-stdout contract and
error messages as racon_tpu.cli (whose HELP text and build_config it
reuses), with the backends auto, cuda, native and python. racon's CUDA
flags (-c/-b/--cudaaligner-*) select the cuda backend. Not available here:
--profile and --distributed (multi-GPU is a later slice).
"""

from __future__ import annotations

import argparse
import sys

from racon_tpu import RACON_VERSION
from racon_tpu.cli import HELP as _HELP, build_config
from racon_tpu.errors import RaconError
from racon_tpu.models.polish_model import PolisherConfig

from .backends import BACKENDS, BackendUnavailable, resolve_backend
from .polisher import create_polisher

HELP = _HELP.replace("compute backend: auto, tpu, native, python",
                     "compute backend: " + ", ".join(BACKENDS))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-u", "--include-unpolished", action="store_true")
    p.add_argument("-f", "--fragment-correction", action="store_true")
    p.add_argument("-w", "--window-length", type=int, default=500)
    p.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    p.add_argument("-e", "--error-threshold", type=float, default=0.3)
    p.add_argument("--no-trimming", action="store_true")
    p.add_argument("-m", "--match", type=int, default=3)
    p.add_argument("-x", "--mismatch", type=int, default=-5)
    p.add_argument("-g", "--gap", type=int, default=-4)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--backend", type=str, default="auto")
    p.add_argument("--band-width", type=int, default=0)
    p.add_argument("--max-window-depth", type=int, default=200)
    p.add_argument("--refine-passes", type=int, default=4)
    p.add_argument("--candidate-frac", type=float, default=0.15)
    p.add_argument("--candidate-min", type=int, default=2)
    # racon's CUDA options (src/main.cpp:37-40) select the cuda backend;
    # batch sizing is automatic, so the counts only act as a switch
    p.add_argument("-c", "--cudapoa-batches", type=int, nargs="?", const=1,
                   default=0)
    p.add_argument("-b", "--cuda-banded-alignment", action="store_true")
    p.add_argument("--cudaaligner-batches", type=int, default=0)
    p.add_argument("--cudaaligner-band-width", type=int, default=0)
    p.add_argument("--version", action="store_true")
    p.add_argument("-h", "--help", action="store_true")
    p.add_argument("inputs", nargs="*")
    return p


def make_config(args: argparse.Namespace) -> PolisherConfig:
    """The run's PolisherConfig from parsed arguments, with the backend
    resolved (racon's CUDA flags select cuda; "auto" says on stderr what
    it took). Raises BackendUnavailable."""
    requested = args.backend
    if requested == "auto" and (args.cudapoa_batches
                                or args.cuda_banded_alignment
                                or args.cudaaligner_batches):
        requested = "cuda"
    args.backend = resolve_backend(requested)
    if requested == "auto":
        sys.stderr.write(f"[racon::] backend auto -> {args.backend}\n")
    return build_config(args)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        args = parser().parse_args(argv)
    except SystemExit:
        return 1
    if args.version:
        print(f"v{RACON_VERSION}")
        return 0
    if args.help:
        print(HELP, end="")
        return 0
    if len(args.inputs) < 3:
        sys.stderr.write("[racon::] error: missing input file(s)!\n")
        print(HELP, end="")
        return 1
    try:
        cfg = make_config(args)
    except BackendUnavailable as e:
        sys.stderr.write(f"[racon::] error: {e}\n")
        return 1
    try:
        polisher = create_polisher(args.inputs[0], args.inputs[1],
                                   args.inputs[2], cfg)
        polisher.initialize()
        polished = polisher.polish(not args.include_unpolished)
    except RaconError as e:
        sys.stderr.write(e.message + "\n")
        return 1
    out = sys.stdout.buffer
    for name, data in polished:
        out.write(b">" + name + b"\n" + data + b"\n")
    out.flush()
    polisher.total()
    return 0


def run() -> None:
    """Console-script entry point."""
    sys.exit(main())


if __name__ == "__main__":
    run()
