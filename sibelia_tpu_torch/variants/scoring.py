"""LAGAN's substitution matrix and affine gap parameters (copy of the
constants of ``sibelia_tpu/variants/aligner.py``), kept apart from
``aligner.py`` so that ``kernels/gotoh.py`` and the aligner can both import
them.

Reference: src/lagan/nucmatrix.txt.
"""
from __future__ import annotations

import numpy as np

# reference: src/lagan/nucmatrix.txt
_SCORE = {
    ("A", "A"): 91, ("A", "C"): -114, ("A", "G"): -31, ("A", "T"): -123,
    ("C", "C"): 100, ("C", "G"): -125, ("C", "T"): -31,
    ("G", "G"): 100, ("G", "T"): -114,
    ("T", "T"): 91,
}
GAP_OPEN = -400
GAP_EXTEND = -25

_SM = np.full((256, 256), -43, dtype=np.int32)
for (x, y), s in list(_SCORE.items()):
    _SM[ord(x), ord(y)] = s
    _SM[ord(y), ord(x)] = s
