"""racon-compatible CLI of the port (console script `raconx-torch`;
reference: src/main.cpp).

Same positional arguments, options, defaults, FASTA-on-stdout contract and
error messages as racon_tpu/cli.py, with the backends auto (= cuda),
cuda, native and python. racon's CUDA flags (-c/-b/--cudaaligner-*)
select the cuda backend. --profile <dir> writes a torch.profiler trace of
create_polisher -> initialize -> polish into <dir>. --distributed (or
RACON_TPU_DISTRIBUTED=1) runs one of several processes started by
torchrun (`python -m torch.distributed.run --nproc-per-node N -m
racon_tpu_torch.cli --distributed ...`): the gloo group comes up from
torchrun's environment before any device use, each process aligns and
polishes its shard on its own GPUs, and rank 0 alone prints the FASTA.
The arguments and the input files are checked before the backend is
resolved, so racon's own error messages come first; without a GPU, auto
and cuda then exit 1 with a message.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import RACON_VERSION
from .backends import BACKENDS, BackendUnavailable
from .errors import RaconError
from .models.polish_model import PolisherConfig, PolisherType
from .polisher import create_polisher

HELP = """usage: racon [options ...] <sequences> <overlaps> <target sequences>

    #default output is stdout
    <sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences used for correction
    <overlaps>
        input file in MHAP/PAF/SAM format (can be compressed with gzip)
        containing overlaps between sequences and target sequences
    <target sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences which will be corrected

    options:
        -u, --include-unpolished
            output unpolished target sequences
        -f, --fragment-correction
            perform fragment correction instead of contig polishing
            (overlaps file should contain dual/self overlaps!)
        -w, --window-length <int>
            default: 500
            size of window on which POA is performed
        -q, --quality-threshold <float>
            default: 10.0
            threshold for average base quality of windows used in POA
        -e, --error-threshold <float>
            default: 0.3
            maximum allowed error rate used for filtering overlaps
        --no-trimming
            disables consensus trimming at window ends
        -m, --match <int>
            default: 3
            score for matching bases
        -x, --mismatch <int>
            default: -5
            score for mismatching bases
        -g, --gap <int>
            default: -4
            gap penalty (must be negative)
        -t, --threads <int>
            default: 1
            number of threads
        --backend <str>
            default: auto
            compute backend: """ + ", ".join(BACKENDS) + """
            (auto = cuda, which needs a GPU; native and python run on
            the host only when named)
        --band-width <int>
            default: 0 (auto: 10%% of mean overlap length)
            band width for device overlap alignment
        --max-window-depth <int>
            default: 200
            maximum layers per window on the device path
        --refine-passes <int>
            default: 4
            iterative consensus refinement passes (1 = single-pass POA)
        --candidate-frac <float> / --candidate-min <int>
            default: 0.15 / 2
            support thresholds for insertion candidates between passes
        --profile <dir>
            write a torch.profiler trace (host and, on a GPU, device
            activity) of the run into <dir>, as Chrome-trace JSON that
            TensorBoard and Perfetto read
        --distributed
            one process of a multi-process run started by torchrun:
            initialize torch.distributed (gloo) from torchrun's
            environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK),
            shard overlap alignment and window consensus per process,
            each process on its own GPUs (LOCAL_RANK), gather to rank 0
            for output (also enabled by RACON_TPU_DISTRIBUTED=1)
        --version
            prints the version number
        -h, --help
            prints the usage

    accepted for drop-in compatibility with racon's CUDA build (they select
    the cuda backend; batch counts are managed automatically):
        -c, --cudapoa-batches <int>
            default: 0
            number of batches for CUDA accelerated polishing
        -b, --cuda-banded-alignment
            use banding approximation for polishing on GPU. Only applicable
            when -c is used.
        --cudaaligner-batches <int>
            default: 0
            number of batches for CUDA accelerated alignment
        --cudaaligner-band-width <int>
            default: 0
            band width for cuda alignment (0 = auto band width)
"""


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
    p.add_argument("--profile", type=str, default=None)
    p.add_argument("--distributed", action="store_true")
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
    """The run's PolisherConfig from parsed arguments (racon_tpu/cli.py
    build_config). racon's CUDA flags select cuda; the backend is resolved
    later, by create_polisher, after the inputs are checked."""
    backend = args.backend
    if backend == "auto" and (args.cudapoa_batches
                              or args.cuda_banded_alignment
                              or args.cudaaligner_batches):
        backend = "cuda"
    return PolisherConfig(
        type=PolisherType.kF if args.fragment_correction else PolisherType.kC,
        window_length=args.window_length,
        quality_threshold=args.quality_threshold,
        error_threshold=args.error_threshold,
        trim=not args.no_trimming,
        match=args.match,
        mismatch=args.mismatch,
        gap=args.gap,
        num_threads=args.threads,
        backend=backend,
        band_width=args.band_width or args.cudaaligner_band_width,
        max_window_depth=args.max_window_depth,
        refine_passes=args.refine_passes,
        candidate_frac=args.candidate_frac,
        candidate_min=args.candidate_min,
    )


def _start_profiler(trace_dir: str):
    """A started torch.profiler session that writes its trace into
    trace_dir when stopped (racon_tpu/cli.py's jax.profiler trace); None,
    with a warning, where the profiler cannot start."""
    try:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(trace_dir))
        prof.start()
        return prof
    except (ImportError, RuntimeError, OSError) as e:
        sys.stderr.write(f"[racon::] warning: profiler unavailable: {e}\n")
        return None


def _stop_profiler(prof) -> None:
    try:
        prof.stop()  # writes <dir>/<host>_<pid>.<ms>.pt.trace.json
    except (RuntimeError, OSError) as e:
        sys.stderr.write(f"[racon::] warning: profiler trace not written: "
                         f"{e}\n")


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
    out = sys.stdout.buffer
    distributed = args.distributed or \
        os.environ.get("RACON_TPU_DISTRIBUTED") == "1"
    if distributed:
        # keep fd 1 for the FASTA: a private handle on the real stdout
        # carries the records, and fd 1 points at stderr, where any
        # library chatter then lands
        sys.stdout.flush()
        out = os.fdopen(os.dup(1), "wb")
        os.dup2(2, 1)
        # before any device use, so each process takes its own GPUs
        from .parallel import dist

        dist.initialize()
    rc = 1
    try:
        rc = _polish(args, out)
        return rc
    finally:
        if distributed:
            # every rank leaves the group together, before Python's exit
            dist.shutdown(wait=rc == 0)


def _polish(args, out) -> int:
    profiler = _start_profiler(args.profile) if args.profile else None
    try:
        polisher = create_polisher(args.inputs[0], args.inputs[1],
                                   args.inputs[2], make_config(args))
        polisher.initialize()
        polished = polisher.polish(not args.include_unpolished)
    except RaconError as e:
        sys.stderr.write(e.message + "\n")
        return 1
    except BackendUnavailable as e:
        sys.stderr.write(f"[racon::] error: {e}\n")
        return 1
    finally:
        if profiler is not None:
            _stop_profiler(profiler)
    for name, data in polished:  # [] on every rank but 0
        out.write(b">" + name + b"\n" + data + b"\n")
    out.flush()
    polisher.total()
    return 0


def run() -> None:
    """Console-script entry point."""
    sys.exit(main())


if __name__ == "__main__":
    run()
