"""The plain reference that decides ``correct``: numpy readers of the
program's output files, held to the benchmark's own genomes.  Imports
nothing of the program."""
from __future__ import annotations

import os
import sys

from ..genomes import Inputs
from .blocks import judge_blocks
from .variants import judge_variants


def judge(program: str, out: str, inputs: Inputs, config: dict) -> dict:
    """Every number the configuration's limits hold, for one job's output
    directory; none where the files cannot be read as their formats say
    (the run is then not correct)."""
    try:
        if program == "sibelia":
            return judge_blocks(os.path.join(out, "blocks_coords.txt"),
                                inputs, config["min_block_size"])
        if program == "csibelia":
            return judge_variants(out, inputs, config["min_block_size"],
                                  config["scoring"])
    except (OSError, ValueError, IndexError, KeyError) as e:
        print(f"the output of {out} is unreadable: {e!r}", file=sys.stderr)
        return {}
    raise ValueError(f"no reference for program {program!r}")
