"""The port's host/device overlap on the CPU (device="cpu": the kernels'
plain versions), against the JAX package:

- TorchConsensusStage at RACON_TPU_COHORTS = 1, 2 and 3 equals
  racon_tpu's TpuConsensusStage (interpreted kernels, real tier shapes)
  at the same forced count, byte for byte, and itself across counts,
  with windows retired inside a cohort before the last pass;
- _auto_cohorts against the reference's policy;
- ops/prefetch: the RACON_TPU_FETCH_THREADS knob and resolve();
- `--profile <dir>` writes a torch.profiler trace, the FASTA unchanged.
"""

import contextlib
import io
import json
from collections import Counter

import numpy as np
import pytest
import torch

from racon_tpu.models.polish_model import PolisherConfig as JaxPolisherConfig
from racon_tpu.native import bindings as jax_bindings
from racon_tpu.ops.consensus_stage_tpu import TpuConsensusStage
from racon_tpu.utils.logger import Logger
from racon_tpu_torch import cli
from racon_tpu_torch.models.polish_model import PolisherConfig
from racon_tpu_torch.native import bindings
from racon_tpu_torch.ops import consensus_stage as cs
from racon_tpu_torch.ops import prefetch
from racon_tpu_torch.polisher import create_polisher

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
W = 200      # window length: the (256,128) tier
N_WIN = 6


def _dataset(d, seed=5):
    """A 1.2 kb contig in six 200 bp windows, two substitutions in each
    window whose rank is not 2 mod 3, and 12 error-free reads over it
    (PAF, no CIGARs)."""
    rng = np.random.default_rng(seed)
    glen = W * N_WIN
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    for w in range(N_WIN):
        if w % 3 != 2:
            for pos in w * W + 20 + rng.choice(W - 40, 2, replace=False):
                draft[pos] = ACGT[(np.searchsorted(ACGT, draft[pos]) + 1)
                                  % 4]
    reads, paf = [], []
    for r in range(12):
        s = int(rng.integers(0, glen // 3))
        e = int(rng.integers(2 * glen // 3, glen))
        reads.append(b">r%d\n%s\n" % (r, true[s:e].tobytes()))
        paf.append(b"r%d\t%d\t0\t%d\t+\tctg\t%d\t%d\t%d\t9\t9\t60\n"
                   % (r, e - s, e - s, glen, s, e))
    (d / "r.fasta").write_bytes(b"".join(reads))
    (d / "o.paf").write_bytes(b"".join(paf))
    (d / "d.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    return [str(d / f) for f in ("r.fasta", "o.paf", "d.fasta")]


def _retire_in_round_two(monkeypatch, module):
    """Both packages' native merge never reports a converged window
    (rt_poa_round_batch leaves RoundState.cur_del empty, so its fixed-point
    test cannot hold): mark the windows of odd rank converged in their
    second round, the same way in both, so cohorts retire windows before
    the last pass. Returns the per-window round counter (cleared by the
    caller between runs)."""
    orig = module.poa_round_batch
    rounds = Counter()

    def patched(*args, **kw):
        res = orig(*args, **kw)
        win_id, win_rank = args[17], args[18]
        for z, key in enumerate(zip(win_id.tolist(), win_rank.tolist())):
            rounds[key] += 1
            if len(res) == 10 and key[1] % 2 and rounds[key] == 2:
                res[9][z] = True
        return res

    monkeypatch.setattr(module, "poa_round_batch", patched)
    return rounds


def test_cohorts_match_jax_stage(tmp_path, monkeypatch):
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    cfg = PolisherConfig(backend="cuda", num_threads=2, match=5,
                         mismatch=-4, gap=-8, window_length=W)
    jcfg = JaxPolisherConfig(num_threads=2, match=5, mismatch=-4, gap=-8,
                             window_length=W)
    with contextlib.redirect_stderr(io.StringIO()):
        p = create_polisher(*_dataset(tmp_path), cfg, device="cpu")
        p.initialize()
    windows = p.windows
    assert [windows.n_layers(w) >= 2 for w in range(windows.num_windows)] \
        == [True] * N_WIN
    layers = np.array([windows.n_layers(w) for w in range(N_WIN)])
    port_rounds = _retire_in_round_two(monkeypatch, bindings)
    jax_rounds = _retire_in_round_two(monkeypatch, jax_bindings)
    subsets = []
    orig_subset = cs._RoundState.subset

    def subset(state, keep_z):
        subsets.append((len(state.off) - 1, len(keep_z)))
        orig_subset(state, keep_z)

    monkeypatch.setattr(cs._RoundState, "subset", subset)
    outs = []
    for n in (1, 2, 3):
        monkeypatch.setenv("RACON_TPU_COHORTS", str(n))
        port_rounds.clear()
        jax_rounds.clear()
        subsets.clear()
        with contextlib.redirect_stderr(io.StringIO()):
            port = cs.TorchConsensusStage(cfg, "cpu")
            got = port.consensus_windows(windows, cfg, Logger())
            want = TpuConsensusStage(jcfg, interpret=True) \
                .consensus_windows(windows, jcfg, Logger())
        assert port.n_cohorts == n
        assert got == want, n
        # each cohort retired its odd-rank windows after pass 2 and went on
        # with the rest
        bounds = np.linspace(0, N_WIN, n + 1).astype(int)
        assert subsets == [(hi - lo, (hi - lo + 1 - lo % 2) // 2)
                           for lo, hi in zip(bounds[:-1], bounds[1:])]
        assert port_rounds == jax_rounds
        assert port.prof["device_items"] > 0
        assert [sum(t.values()) for t in port.tier_items] \
            == [layers.sum()] * 2 + [layers[::2].sum()] * 2
        outs.append(got)
    assert outs[0] == outs[1] == outs[2]


class _Ref(TpuConsensusStage):
    """The reference's stage, for its _auto_cohorts."""

    def __init__(self, interpret):
        super().__init__(JaxPolisherConfig(), interpret)


@pytest.mark.parametrize("device,n_active,passes,env,want", [
    ("cuda", 256, 2, None, 3),
    ("cuda", 2048, 4, None, 3),
    ("cuda", 255, 4, None, 1),
    ("cuda", 4096, 1, None, 1),
    ("cpu", 2048, 4, None, 1),
    ("cpu", 2048, 4, "2", 2),
    ("cuda", 2048, 4, "1", 1),
    ("cuda", 2, 4, "3", 2),
    ("cpu", 0, 4, "3", 1),
])
def test_auto_cohorts(monkeypatch, device, n_active, passes, env, want):
    if env is None:
        monkeypatch.delenv("RACON_TPU_COHORTS", raising=False)
    else:
        monkeypatch.setenv("RACON_TPU_COHORTS", env)
    stage = cs.TorchConsensusStage(PolisherConfig(), device)
    assert stage._auto_cohorts(n_active, passes) == want
    # the reference's function wherever it does not probe the link: on
    # the CPU (interpreted) always, on a device below its thresholds
    interpret = device == "cpu"
    if interpret or n_active < 256 or passes < 2:
        assert _Ref(interpret)._auto_cohorts(n_active, passes) == want


def test_prefetch_knob_and_resolve(monkeypatch):
    """RACON_TPU_FETCH_THREADS=0: no handle, resolve() fetches inline; a
    positive or malformed value: a handle whose resolve() returns the
    payload's bytes (on the CPU, the same array)."""
    payload = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    monkeypatch.setenv("RACON_TPU_FETCH_THREADS", "0")
    assert not prefetch.enabled()
    assert prefetch.submit(payload) is None
    assert np.array_equal(prefetch.resolve(payload, None), payload.numpy())
    for value in ("2", "bogus"):
        monkeypatch.setenv("RACON_TPU_FETCH_THREADS", value)
        assert prefetch.enabled()
        fetch = prefetch.submit(payload)
        assert fetch is not None and fetch.event is None
        got = prefetch.resolve(payload, fetch)
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, payload.numpy())
    monkeypatch.delenv("RACON_TPU_FETCH_THREADS")
    assert prefetch.enabled()  # default 4


def _cli(argv):
    out = io.BytesIO()

    class _Stdout:
        buffer = out

    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(_Stdout()):
        code = cli.main(argv)
    return code, out.getvalue(), err.getvalue()


def test_profile_writes_trace(tmp_path):
    paths = _dataset(tmp_path)
    trace_dir = tmp_path / "trace"
    code, plain, _ = _cli(["--backend", "native", "-w", str(W), *paths])
    assert code == 0 and plain.startswith(b">ctg")
    code, profiled, err = _cli(["--profile", str(trace_dir), "--backend",
                                "native", "-w", str(W), *paths])
    assert code == 0, err
    assert profiled == plain
    assert "profiler unavailable" not in err
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert events
    assert "--profile" in cli.HELP
    assert cli.parser().parse_args(["--profile", "d", "a", "b", "c"]) \
        .profile == "d"
