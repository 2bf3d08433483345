"""One run of one cell: set-up, the measured window of whole racon jobs,
the metrics, and the check of every job's answers against the plain
reference.

Set-up (`setup_s`, from the process's start): PREFAULT_GIB of memory
populated and given back, the cell's inputs from the seed by the frozen
generators (into a directory under TMPDIR), the kernels and the native
runtime loaded from their build directories inside the checkout (built
there on a checkout's first run), one untimed warm job on the same
input (so every tier the window launches has launched, and the host's
and the device's allocators have grown to a job's size), and a garbage
collection. The program gets every core the process may use.

Window (window.py): jobs back to back on the same input files; a job is
`create_polisher` -> `initialize()` -> `polish(drop_unpolished_sequences
=True)` -> the FASTA bytes in memory. With `trace` the window runs under
torch.profiler, with the benchmark's own `portbench::` spans around each
layer call.
"""

from __future__ import annotations

import contextlib
import gc
import json
import mmap
import os
import resource
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

from . import check, devtrace, hostinfo, spec, synth, window
from .reference import racon

FORBIDDEN = ("jax", "jaxlib", "flax", "racon_tpu")
# above the host memory a run holds besides (its RSS peaks at 5-10 GiB):
# the window's allocations then meet pages the host has already backed
# (PERF.md: a set's trimmed range 27.3 % without a prefault and 9.9 %
# with 32 GiB in one call; 6.6-19.8 % with 16 GiB)
PREFAULT_GIB = 16


@dataclass
class Run:
    """What the metric readers see."""
    jobs: list[dict]
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: dict | None = None

    @property
    def kbp_per_s(self) -> float:
        return window.rate(self.jobs, self.window_s) / 1000.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prefault(gib: float) -> float:
    """Map `gib` GiB of fresh memory populated in one call and give it
    back: the window's allocations then find pages the host has already
    backed, where a fresh machine otherwise backs each on first touch.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    if gib > 0:
        mmap.mmap(-1, int(gib * 2**30),
                  flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                  | getattr(mmap, "MAP_POPULATE", 0)).close()
    return time.perf_counter() - t0


def make_inputs(workdir: str, cfg: dict, traffic: dict, genome_bp: int,
                seed) -> dict:
    """Write a job's input files by the traffic's generator; returns the
    paths (reads, overlaps, targets)."""
    os.makedirs(workdir, exist_ok=True)
    r = cfg["reads"]
    gen = traffic["generator"]
    if gen == "sam":
        synth.make_sam_dataset(workdir, genome_bp, r["length"],
                               r["coverage"], r["error"], seed=seed)
    else:
        synth.make_dataset(workdir, genome_bp, r["length"], r["coverage"],
                           r["error"], seed=seed, mix=tuple(r["mix"]),
                           ava=gen == "ava")
    names = {"paf": ("reads.fasta", "ovl.paf", "draft.fasta"),
             "sam": ("reads.fasta", "ovl.sam", "draft.fasta"),
             "ava": ("reads.fasta", "ava.paf", "reads.fasta")}[gen]
    return dict(zip(("reads", "overlaps", "targets"),
                    (os.path.join(workdir, n) for n in names)))


def polisher_config(cfg: dict, threads: int):
    from racon_tpu_torch.models.polish_model import (PolisherConfig,
                                                     PolisherType)

    p = cfg["polisher"]
    return PolisherConfig(
        type=PolisherType[p["type"]], window_length=p["window_length"],
        quality_threshold=p["quality_threshold"],
        error_threshold=p["error_threshold"], trim=p["trim"],
        match=p["match"], mismatch=p["mismatch"], gap=p["gap"],
        num_threads=threads, backend=p["backend"],
        refine_passes=p["refine_passes"],
        candidate_frac=p["candidate_frac"],
        candidate_min=p["candidate_min"],
        max_window_depth=p["max_window_depth"])


class Recorder:
    """Keeps what each consensus_windows() call returned, and with
    `spans` names the two stage calls in a profiler trace. Installed on
    the stage classes for the run; `remove()` puts them back."""

    def __init__(self, spans: bool):
        import torch
        from racon_tpu_torch.ops.align_stage import TorchAlignStage
        from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage

        self.answers: list = []
        self._saved = []
        rf = torch.profiler.record_function
        keep = self.answers

        def wrap(cls, attr, span, record):
            orig = getattr(cls, attr)
            self._saved.append((cls, attr, orig))

            def call(*a, **kw):
                with (rf(span) if spans else contextlib.nullcontext()):
                    out = orig(*a, **kw)
                if record:
                    keep.append(out)
                return out
            setattr(cls, attr, call)

        wrap(TorchAlignStage, "breaking_points", "portbench::align", False)
        wrap(TorchConsensusStage, "consensus_windows",
             "portbench::consensus", True)

    def remove(self):
        for cls, attr, orig in reversed(self._saved):
            setattr(cls, attr, orig)


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_job(paths: dict, pcfg, device, spans: bool) -> tuple[dict, object]:
    """One whole job; returns its record and its (records, windows)."""
    import torch

    from racon_tpu_torch.polisher import create_polisher

    rf = (torch.profiler.record_function if spans
          else lambda _: contextlib.nullcontext())
    cpu0 = hostinfo.cpu_times()
    t0 = time.perf_counter()
    with rf("portbench::create_polisher"):
        p = create_polisher(paths["reads"], paths["overlaps"],
                            paths["targets"], pcfg,
                            device=None if device == "cuda" else device)
    with rf("portbench::initialize"):
        p.initialize()
        _sync(device)
    t1 = time.perf_counter()
    with rf("portbench::polish"):
        out = p.polish(drop_unpolished_sequences=True)
        _sync(device)
    with rf("portbench::fasta"):
        fasta = b"".join(b">%s\n%s\n" % (n, d) for n, d in out)
    t2 = time.perf_counter()
    cs, al = p.consensus_stage, p.align_stage
    rec = {
        "initialize_s": t1 - t0, "polish_s": t2 - t1,
        "bases": int(sum(len(p.sequences.data(t))
                         for t in range(p.targets_size))),
        "fasta_bytes": len(fasta),
        "dispatch_s": cs.prof.get("dispatch_s", 0.0),
        "poa_round_s": cs.prof.get("poa_round_s", 0.0),
        "decode_s": cs.prof.get("decode_s", 0.0),
        "items": al.stats["items"] if al is not None else 0,
        "host_items": al.stats["host_items"] if al is not None else 0,
        "align_tiers": sorted(str(k) for k in al.stats["tier_items"])
        if al is not None else [],
        "consensus_tiers": sorted({str(k) for d in cs.tier_items
                                   for k in d}),
        **hostinfo.shares(cpu0, hostinfo.cpu_times()),
        "load1": hostinfo.loadavg(),
    }
    return rec, (out, p.windows)


def run_cell(workload: str, cfg: dict, traffic: dict, seed, seconds: float,
             trace: bool, t_origin: float, device: str = "cuda",
             metrics: list[dict] = (), root: str = spec.ROOT,
             genome_bp: int | None = None, log=print) -> dict:
    """Set-up, window, metrics and check of one run; returns the result
    object of the run's last line (its keys in the order printed)."""
    import torch

    prefault_s = prefault(PREFAULT_GIB)
    cores = hostinfo.usable_cores()
    torch.set_num_threads(cores)
    pcfg = polisher_config(cfg, cores)
    genome_bp = genome_bp or cfg["genome_bp"]
    work = tempfile.mkdtemp(prefix="portbench-")
    devnull = open(os.devnull, "w")
    try:
        paths = make_inputs(os.path.join(work, "full"), cfg, traffic,
                            genome_bp, seed)
        if device == "cuda":
            from racon_tpu_torch.kernels.build import kernels
            from racon_tpu_torch.native import loader

            kernels()
            loader.get()
        t_warm = time.perf_counter()
        with contextlib.redirect_stderr(devnull):
            warm, _ = run_job(paths, pcfg, device, spans=False)
        t_warm = time.perf_counter() - t_warm
        gc.collect()
        _sync(device)
        setup_s = time.perf_counter() - t_origin
        host = {"usable_cores": cores, "cpu_count": os.cpu_count(),
                "setup_s": setup_s, "prefault_s": prefault_s,
                "warm_job_s": t_warm,
                "warm_align_tiers": warm["align_tiers"],
                "warm_consensus_tiers": warm["consensus_tiers"]}
        if device == "cuda":
            host.update(card=hostinfo.card())
        log("host " + json.dumps(host))

        recorder = Recorder(spans=trace)
        kept = []

        def job(k):
            r, ans = run_job(paths, pcfg, device, spans=trace)
            kept.append(ans)
            return r

        prof = None
        try:
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stderr(devnull):
                if trace:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
                try:
                    with torch.profiler.record_function(
                            devtrace.WINDOW_SPAN) if trace \
                            else contextlib.nullcontext():
                        jobs, window_s = window.run_window(job, seconds)
                finally:
                    if prof is not None:
                        prof.__exit__(None, None, None)
        finally:
            recorder.remove()
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        for k, r in enumerate(jobs):
            log("job " + json.dumps({"job": k, **r}))
        missing = sorted(set(jobs[0]["align_tiers"]
                             + jobs[0]["consensus_tiers"])
                         - set(warm["align_tiers"]
                               + warm["consensus_tiers"]))
        log("tiers " + json.dumps({"window_tiers_not_warmed": missing}))
        log("memory " + json.dumps({"host_peak_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20}))
        summary = None
        if prof is not None:
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            summary = devtrace.summarize(devtrace.load(path))
            os.remove(path)
        run = Run(jobs, window_s, setup_s, peak, summary)

        # the program's answers for the check; then its state goes
        consensus = recorder.answers
        job_ref = racon.load_job(
            paths["reads"], paths["overlaps"], paths["targets"],
            cfg["polisher"]["window_length"],
            cfg["polisher"]["error_threshold"],
            cfg["polisher"]["type"] == "kF")
        regions = check.sample_windows(job_ref, seed,
                                       traffic["check"]["regions"],
                                       traffic["check"]["windows"])
        sampled = sorted({int(job_ref.first_window[t]) + r
                          for t, lo, hi in regions for r in range(lo, hi)})
        answers = []
        for (out, wins), (cons, pol) in zip(kept, consensus):
            answers.append({
                "records": out, "consensus": cons, "polished": pol,
                "layers": {w: [(int(wins.lay_begin[li]),
                                int(wins.lay_end[li]),
                                wins.layer_data(int(li)).tobytes())
                               for li in wins.layer_indices(w)]
                           for w in sampled}})
        del kept, consensus, recorder
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        ref = check.reference_answers(job_ref, regions, cfg["polisher"],
                                      cores)
        numbers, failed = check.compare(
            job_ref, ref, answers,
            cfg["polisher"]["drop_unpolished_sequences"])
        quality = {}
        if traffic["generator"] == "ava":
            quality = racon.identity_kf(
                os.path.dirname(paths["reads"]), answers[0]["records"],
                traffic["check"].get("identity_reads", 0), seed)
        log("reference " + json.dumps({
            "seconds": time.perf_counter() - t_ref, "regions": regions,
            "windows": len(ref), **quality}))
        rec = {
            "correct": check.verdict(numbers) and len(answers) == len(jobs),
            "attempted": len(jobs), "failed": failed,
            "metrics": {}, "device": {},
        }
        for m in metrics:
            value = spec.reader(m["name"], root)(run)
            if value is not None:
                rec["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        rec["device"] = device_record(device, peak, summary)
        if summary is not None:
            rec["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
        rec["check"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
        rec["_lines"] = check.lines(numbers)
        return rec
    finally:
        devnull.close()
        shutil.rmtree(work, ignore_errors=True)


def device_record(device: str, peak: int, summary: dict | None) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        d.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    return d
