"""The native star-POA merge, the stage's prof["poa_round_s"] a job."""


def read(run):
    return sum(j["poa_round_s"] for j in run.jobs) / len(run.jobs)
