"""Pattern-type masks for variable-length sequences.

The reference marks every (timestep, sequence) slot in a padded fraction
with a pattern type (`Types.hpp:30-33`): FIRST (first frame of a sequence),
NORMAL, LAST, or NONE (padding). Compute for NONE slots is skipped/zeroed.

The port keeps the same encoding as an int8 [T, B] array; layers consume a
validity mask (the LSTM kernel reduces it to per-row lengths). Because
padding is always a suffix of each sequence, masking the scan state to zero
at NONE slots makes a globally time-reversed scan equivalent to the
reference's per-buffer backward iteration.
"""

from __future__ import annotations

import numpy as np

PATTYPE_NONE = 0
PATTYPE_FIRST = 1
PATTYPE_NORMAL = 2
PATTYPE_LAST = 3


def pattypes_from_lengths(lengths, max_len: int, n_parallel: int) -> np.ndarray:
    """Build the [T, B] int8 patTypes array from per-sequence lengths.

    Mirrors DataSet.cpp:397-407. `lengths` may be shorter than `n_parallel`
    (last fraction); missing slots are all-NONE.
    """
    pt = np.full((max_len, n_parallel), PATTYPE_NONE, dtype=np.int8)
    for i, L in enumerate(lengths):
        if L <= 0:
            continue
        # DataSet.cpp:397-407: timestep 0 -> FIRST (wins over LAST for L==1),
        # last timestep -> LAST, rest NORMAL.
        pt[1 : L - 1, i] = PATTYPE_NORMAL
        if L > 1:
            pt[L - 1, i] = PATTYPE_LAST
        pt[0, i] = PATTYPE_FIRST
    return pt
