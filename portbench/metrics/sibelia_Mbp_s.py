from portbench.readers import rate_mbp_s


def read(run):
    return rate_mbp_s(run, "sibelia")
