"""Wave detections the apply loop found stale and recomputed serially, as
a share of the ids the wave detected in parallel (the native engine's
counters ``wave_stale`` and ``wave_detections``), over the window's jobs;
None where the jobs carry no such counters."""


def read(run):
    if run.program != "sibelia" or not run.jobs:
        return None
    if any("wave_detections" not in j.phases for j in run.jobs):
        return None
    detected = sum(j.phases["wave_detections"] for j in run.jobs)
    if not detected:
        return None
    return 100.0 * sum(j.phases["wave_stale"] for j in run.jobs) / detected
