def read(run):
    return run.setup_s
