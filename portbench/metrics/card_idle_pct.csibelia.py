from portbench.readers import card_idle_pct


def read(run):
    return card_idle_pct(run, "csibelia")
