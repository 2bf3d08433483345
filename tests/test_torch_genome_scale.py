"""The port's genome-scale run (racon_tpu_torch/benchmarks/genome_scale.py)
on the CPU at a toy size: main(argv, device="cpu") runs the cuda backend's
plain versions and prints one JSON record, in both modes; without a GPU
the default backend (auto = cuda) exits 1 and never falls back to the
host."""

import contextlib
import io
import json

import pytest
import torch

from racon_tpu_torch.benchmarks import genome_scale

torch.set_num_threads(2)


def _run(argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = genome_scale.main(argv, **kw)
    return rc, out.getvalue()


@pytest.mark.parametrize("mode,size", [
    ("polish", ["--genome-mb", "0.02", "--read-len", "2000"]),
    ("kf", ["--genome-mb", "0.006", "--read-len", "2000", "--coverage", "8",
            "--error", "0.06"])])
def test_genome_scale_record_on_the_plain_versions(tmp_path, mode, size):
    path = tmp_path / "rec.json"
    rc, out = _run(["--mode", mode, *size, "--backend", "cuda",
                    "--threads", "2", "--workdir", str(tmp_path / "data"),
                    "--json", str(path)], device="cpu")
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec == json.loads(path.read_text())
    assert rec["mode"] == mode and rec["backend"] == "cuda"
    assert rec["device"] == {"platform": "cpu"}
    assert rec["peak_device_bytes"] is rec["kernels_load_s"] is None
    assert rec["peak_host_rss_bytes"] > 0 and rec["windows"] > 0
    assert rec["initialize_s"] > 0 and rec["polish_s"] > 0
    assert rec["align_host_items"] == 0
    assert sum(t["items"] for t in rec["align_tier_items"]) \
        == rec["align_items"] > 0
    assert all(t["tier"] is not None for t in rec["align_tier_items"])
    if mode == "kf":
        assert rec["reads_corrected"] > 10
        assert rec["identity_pct"] > rec["raw_read_identity_pct"] + 1
    else:
        assert 0 < rec["edit_vs_truth"] < rec["draft_edit"] + 600


def test_genome_scale_needs_a_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: auto resolves to cuda")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, out = _run(["--genome-mb", "0.02", "--read-len", "2000",
                        "--workdir", str(tmp_path)])
    assert rc == 1
    assert "no CUDA device" in err.getvalue()
    assert not out.strip().endswith("}")
