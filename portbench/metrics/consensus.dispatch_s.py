"""The consensus stage's prof["dispatch_s"] a job: pack, upload, launch."""


def read(run):
    return sum(j["dispatch_s"] for j in run.jobs) / len(run.jobs)
