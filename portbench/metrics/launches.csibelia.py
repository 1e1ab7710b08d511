from portbench.readers import launches_per_job


def read(run):
    return launches_per_job(run, "csibelia")
