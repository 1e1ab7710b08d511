from portbench.readers import phase_per_job


def read(run):
    return phase_per_job(run, "anchoring", "csibelia")
