"""k_gotoh_align's share of its roofline over the traced window: 100 x
the least time the H100 could take for the window's gap batches (the
larger of their bytes at 3.35 TB/s and their operations at the 67 T/s
float32 rate) over the kernel's device seconds.  The batches' shape is
the program's counters ``gotoh_cells`` (the DP cells of the gaps' true
lengths) and ``gotoh_bytes`` (the bytes the kernel touches: the score
tables, each gap's lengths and bases read, its length and its rows up to
that length written; the padding of the buffers is not counted)."""

BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_CELL = 20  # the kernels table's convention (PERF.md section 6)
KERNEL = "k_gotoh_align"


def operations(cells: float) -> float:
    return OPS_PER_CELL * cells


def bytes_moved(nbytes: float) -> float:
    """Each byte the kernel touches, read or written once."""
    return nbytes


def bound_s(cells: float, nbytes: float) -> float:
    return max(bytes_moved(nbytes) / BYTES_PER_S, operations(cells) / OPS_PER_S)


def read(run):
    if run.program != "csibelia" or not run.jobs or run.events is None:
        return None
    cells = sum(j.phases.get("gotoh_cells", 0) for j in run.jobs)
    nbytes = sum(j.phases.get("gotoh_bytes", 0) for j in run.jobs)
    ns = sum(e - s for n, s, e in run.events if KERNEL in n)
    if not cells or not ns:
        return None
    return 100.0 * bound_s(cells, nbytes) / (ns / 1e9)
