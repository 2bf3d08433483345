"""polish() to the FASTA bytes, seconds a job (host clock, after a device synchronize)."""


def read(run):
    return sum(j["polish_s"] for j in run.jobs) / len(run.jobs)
