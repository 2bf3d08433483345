"""The port's dataset generator (racon_tpu_torch/testing/synth.py), whose
datasets the quality records are measured on (chip_smoke.py's 4.6 Mb
polish, benchmarks/genome_scale.py): its files, byte for byte, pinned by
their SHA-256 at a small size, so that a faster generator still writes
the datasets the records were taken on (a random base per insertion is
one draw of them all, which takes the generator's stream as a draw per
base did)."""

import hashlib
import os

import pytest

from racon_tpu_torch.testing.synth import make_dataset


@pytest.mark.parametrize("kw,digest", [
    (dict(genome_bp=60_000, read_len=4000, coverage=10, err=0.12, seed=11),
     "5d39cd572067104516290437bf91a758b64cde74661e14dd252690a79dd306ff"),
    (dict(genome_bp=60_000, read_len=6000, coverage=10, err=0.12, seed=5,
          chimeric_frac=0.2, mix=(0.2, 0.5, 0.3), ava=True),
     "4c6671700d3c6fc6b36a8e65ebee75868a6c18dc2d77847f0459a10fd5676162"),
])
def test_make_dataset_bytes(tmp_path, kw, digest):
    """Every file make_dataset writes (the truth, draft, reads, PAF; with
    ava the reads-vs-reads PAF and the true spans), hashed in name order:
    the default mix and the deletion-biased one with chimeras."""
    make_dataset(str(tmp_path), **kw)
    h = hashlib.sha256()
    for name in sorted(os.listdir(tmp_path)):
        h.update((tmp_path / name).read_bytes())
    assert h.hexdigest() == digest
