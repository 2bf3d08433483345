"""Genome-scale end-to-end run of the port: a synthetic ONT-like polishing
or fragment-correction run, the port's copy of benchmarks/genome_scale.py.

Generates a genome (default 4.6 Mb, E. coli scale), a draft with ~1 %
errors and ONT-like reads (default 8 kb, 12 % error, 20x coverage) with
PAF overlaps from the known sampling positions (testing/synth.py's
make_dataset: the same bytes as the JAX package's generator), then runs
the port's Polisher (parse -> overlap alignment -> windowing -> consensus
-> stitch) and reports the wall time of initialize() and polish() and the
identity to the truth:

- `--mode polish`: contig polishing; the polished contig's exact edit
  distance to the whole true genome (the port's native Myers aligner);
- `--mode kf`: fragment correction (racon -f) of the reads on
  all-vs-all overlaps (ava.paf); the corrected and the raw reads'
  identity to their true source segments, on a sample of 300 reads.

On the card the kernels are built (on a machine's first use) or loaded
before the timed calls, and the record gives that time apart
(kernels_load_s). The record also holds the peak device memory
(torch.cuda.max_memory_allocated over initialize + polish), the peak
host RSS of the process (dataset synthesis included), the align stage's
items per tier and on the host, and the card's name and power limit.
`--backend` defaults to auto (= cuda, on the card); main(argv,
device="cpu") runs the cuda backend's plain versions, as the tests do.

Usage: python -m racon_tpu_torch.benchmarks.genome_scale [--genome-mb 4.6]
       [--mode polish|kf] [--read-len 8000] [--backend auto] [--threads N]
       [--workdir DIR] [--reuse-data] [--json PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..backends import BackendUnavailable
from ..errors import RaconError
from ..models.polish_model import PolisherConfig, PolisherType
from ..native import bindings
from ..polisher import create_polisher
from ..testing.synth import make_dataset

# error-profile mix: fraction of the read error spent on (ins, del, sub):
# uniform thirds (the tuning profile) or the indel-skewed nanopore mix
PROFILES = {
    "uniform": (1 / 3, 1 / 3, 1 / 3),
    "indel": (0.4, 0.4, 0.2),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.benchmarks.genome_scale",
        description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=4.6)
    ap.add_argument("--coverage", type=int, default=20)
    ap.add_argument("--read-len", type=int, default=8000)
    ap.add_argument("--error", type=float, default=0.12)
    ap.add_argument("--profile", choices=sorted(PROFILES), default="uniform",
                    help="error mix (ins/del/sub fractions of --error)")
    ap.add_argument("--chimeric-frac", type=float, default=0.0,
                    help="fraction of reads built as chimeras (distant-"
                    "locus tails, head-only PAF mapping)")
    ap.add_argument("--mode", choices=("polish", "kf"), default="polish",
                    help="polish: contig polishing (kC); kf: fragment "
                    "correction on reads-vs-reads overlaps (kF)")
    ap.add_argument("--backend", default="auto",
                    help="auto (= cuda, on the card), cuda, native, python")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--refine-passes", type=int, default=None,
                    help="consensus refinement passes (default: "
                    "PolisherConfig's)")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "racon_tpu_torch_genome_scale"))
    ap.add_argument("--reuse-data", action="store_true",
                    help="skip dataset synthesis when the workdir already "
                    "holds it (synthesis is deterministic per seed)")
    ap.add_argument("--verbose", action="store_true",
                    help="show the Polisher's stage timers on stderr")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run create_polisher -> initialize -> polish N "
                    "times in this process; the record's times are the "
                    "first run's")
    ap.add_argument("--json", default=None,
                    help="also write the record to this file")
    return ap


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in smi.split(","))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi_name": name, "power_limit": limit}


def _quiet(verbose):
    return (contextlib.nullcontext() if verbose
            else contextlib.redirect_stderr(io.StringIO()))


def _identity_kf(workdir, true, out):
    """Corrected and raw reads' identity (%) to their true source
    segments on a 300-read sample, and the sample's size. kF appends a
    literal 'r' to each record name (reference: src/polisher.cpp:522)."""
    spans = np.load(os.path.join(workdir, "true_spans.npy"))
    corrected = {nm.split(b" ")[0]: dat for nm, dat in out}
    raws = {}
    with open(os.path.join(workdir, "reads.fasta"), "rb") as f:
        lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 1, 2):
        if lines[i].startswith(b">"):
            raws[lines[i][1:]] = lines[i + 1]
    sample = np.random.default_rng(3).choice(
        len(spans), min(300, len(spans)), replace=False)
    cd = rd = nbp = used = 0
    for r in sample:
        nm = b"r%dr" % r
        if nm not in corrected:
            continue
        seg = true[spans[r, 0] : spans[r, 1]].tobytes()
        cd += bindings.edit_distance(corrected[nm], seg)
        rd += bindings.edit_distance(raws[b"r%d" % r], seg)
        nbp += len(seg)
        used += 1
    return (100.0 * (1.0 - cd / max(nbp, 1)),
            100.0 * (1.0 - rd / max(nbp, 1)), used)


def run(a: argparse.Namespace, device=None) -> dict:
    """One genome-scale run as `a` (parser()'s namespace) describes it;
    returns its record. device: create_polisher's (None: the current GPU
    with the cuda backend; "cpu": the kernels' plain versions)."""
    os.makedirs(a.workdir, exist_ok=True)
    genome_bp = int(a.genome_mb * 1e6)
    t0 = time.perf_counter()
    tf = os.path.join(a.workdir, "true.fasta")
    if a.reuse_data and os.path.exists(tf):
        with open(tf, "rb") as f:
            true = np.frombuffer(f.read().split(b"\n")[1], np.uint8)
    else:
        true = make_dataset(a.workdir, genome_bp, a.read_len, a.coverage,
                            a.error, mix=PROFILES[a.profile],
                            chimeric_frac=a.chimeric_frac,
                            ava=(a.mode == "kf"))
    gen_s = time.perf_counter() - t0
    print(f"dataset (SYNTHETIC): {genome_bp / 1e6:.1f} Mb genome, "
          f"{a.coverage}x {a.read_len} bp reads, {a.error:.0%} error "
          f"({a.profile} mix, chimeric {a.chimeric_frac:.0%}, mode "
          f"{a.mode}), made in {gen_s:.1f} s", flush=True)

    extra = ({"refine_passes": a.refine_passes}
             if a.refine_passes is not None else {})
    if a.mode == "kf":
        extra["type"] = PolisherType.kF
    cfg = PolisherConfig(backend=a.backend, num_threads=a.threads,
                         match=5, mismatch=-4, gap=-8, **extra)
    paths = [os.path.join(a.workdir, f) for f in (
        "reads.fasta", "ava.paf" if a.mode == "kf" else "ovl.paf",
        "reads.fasta" if a.mode == "kf" else "draft.fasta")]
    runs = []
    for it in range(max(1, a.repeat)):
        with _quiet(a.verbose):
            # resolves the backend: auto and cuda raise without a GPU
            p = create_polisher(*paths, cfg, device=device)
            on_card = p.config.backend == "cuda" and (
                device is None or torch.device(device).type == "cuda")
            load_s = None
            if on_card:
                # build (first use on a machine) or load the kernels
                # outside the timed calls
                from ..kernels.build import kernels

                tk = time.perf_counter()
                kernels()
                load_s = time.perf_counter() - tk
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            p.initialize()
            t1 = time.perf_counter()
            out = p.polish(drop_unpolished_sequences=True)
            t2 = time.perf_counter()
        n_win = p.windows.num_windows
        tag = "first" if it == 0 else f"repeat {it}"
        print(f"[{tag}] initialize (parse+align+window): {t1 - t0:.3f} s",
              flush=True)
        print(f"[{tag}] polish ({n_win} windows): {t2 - t1:.3f} s "
              f"({n_win / (t2 - t1):.2f} windows/s)", flush=True)
        runs.append({"kernels_load_s": load_s,
                     "initialize_s": t1 - t0, "polish_s": t2 - t1,
                     "windows_per_s": n_win / (t2 - t1),
                     "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                           if on_card else None)})
    st = getattr(p.align_stage, "stats", None)
    rec = {"data": "synthetic", "mode": a.mode, "genome_bp": genome_bp,
           "coverage": a.coverage, "read_len": a.read_len,
           "read_error": a.error, "error_profile": a.profile,
           "chimeric_frac": a.chimeric_frac,
           "refine_passes": a.refine_passes, "backend": p.config.backend,
           "threads": a.threads, "dataset_s": gen_s,
           **{k: runs[0][k] for k in ("kernels_load_s", "initialize_s",
                                      "polish_s", "windows_per_s",
                                      "peak_device_bytes")},
           "peak_host_rss_bytes":
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
           "windows": p.windows.num_windows, "runs": runs,
           "device": card() if on_card else {"platform": "cpu"}}
    if st is not None:  # the cuda backend's align stage
        # tier None: beyond the last tier, aligned on the host
        rec.update(align_items=st["items"], align_host_items=st["host_items"],
                   align_tier_items=[
                       {"tier": None if k == -1 else list(k), "items": v}
                       for k, v in st["tier_items"].items()])

    t3 = time.perf_counter()
    if a.mode == "kf":
        ident, ident_raw, used = _identity_kf(a.workdir, true, out)
        print(f"kF corrected-read identity vs truth: {ident:.4f}% (raw "
              f"reads {ident_raw:.4f}%; {used} reads sampled, {len(out)} "
              f"corrected; metric {time.perf_counter() - t3:.1f} s)",
              flush=True)
        rec.update(reads_corrected=len(out), sampled_reads=used,
                   identity_pct=ident, raw_read_identity_pct=ident_raw)
    else:
        d = bindings.edit_distance(out[0][1], true.tobytes())
        ident = 100.0 * (1.0 - d / len(true))
        rec.update(edit_vs_truth=int(d), identity_pct=ident)
        # the draft's exact edit distance is O(n d) with d ~ 1 % of the
        # genome: fine at E. coli scale, hours at 50 Mb; the generator
        # injects ~1 % draft error by construction
        if genome_bp <= 10_000_000:
            with open(os.path.join(a.workdir, "draft.fasta"), "rb") as f:
                draft = f.read().split(b"\n", 1)[1].replace(b"\n", b"")
            d_draft = bindings.edit_distance(draft, true.tobytes())
            rec.update(draft_edit=int(d_draft), draft_identity_pct=100.0 * (
                1.0 - d_draft / len(true)))
        print(f"consensus identity vs truth: {ident:.4f}% (edit {d}; "
              f"metric {time.perf_counter() - t3:.1f} s)", flush=True)
    rec["metric_s"] = time.perf_counter() - t3
    return rec


def main(argv=None, device=None) -> int:
    a = parser().parse_args(argv)
    try:
        rec = run(a, device)
    except (RaconError, BackendUnavailable) as e:
        sys.stderr.write(f"[genome_scale] error: {e}\n")
        return 1
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
