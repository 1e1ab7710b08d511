from portbench.readers import kernel_ms_per_job


def read(run):
    return kernel_ms_per_job(run, "csibelia")
