"""initialize() seconds a job (host clock, after a device synchronize)."""


def read(run):
    return sum(j["initialize_s"] for j in run.jobs) / len(run.jobs)
