"""The plain reference that decides ``correct``: numpy readers of the
program's output files, held to the benchmark's own genomes.  Imports
nothing of the program.

Each configuration is judged by one module of this package, which
exports ``judge(out, inputs, config) -> dict``: the one its ``judge`` key
names, or without the key its program's (``DEFAULT``).  A configuration
that needs another comparison brings it as a new module and names it.
"""
from __future__ import annotations

import importlib.util
import os
import re
import sys

from ..genomes import Inputs

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = {"sibelia": "blocks", "csibelia": "variants"}


def judge_name(config: dict) -> str:
    return config.get("judge") or DEFAULT[config["program"]]


def load_judge(config: dict, directory: str = HERE):
    """The ``judge`` function of the configuration's module, read from
    `directory` (this package's, or its copy in another checkout)."""
    name = judge_name(config)
    path = os.path.join(directory, f"{name}.py")
    if not (re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name)
            and os.path.isfile(path)):
        raise ValueError(f"no reference module {name!r} in {directory}")
    # a submodule of this package by name, so that its relative imports
    # resolve here
    spec = importlib.util.spec_from_file_location(f"{__name__}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "judge", None)):
        raise ValueError(f"reference module {name!r} exports no judge")
    return mod.judge


def judge(config: dict, out: str, inputs: Inputs,
          directory: str = HERE) -> dict:
    """Every number the configuration's limits hold, for one job's output
    directory; none where the files cannot be read as their formats say
    (the run is then not correct)."""
    run = load_judge(config, directory)
    try:
        return run(out, inputs, config)
    except (OSError, ValueError, IndexError, KeyError) as e:
        print(f"the output of {out} is unreadable: {e!r}", file=sys.stderr)
        return {}
