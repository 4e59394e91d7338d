"""The benchmark's CPU tests: small sizes, the program's plain twins."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the verify skill's tiny M1 (cfg1's strides and kernels)
TINY = dict(input_spatial_dims=[4, 16, 16], filters=[4, 8, 12, 16, 24],
            se_reduction=[2, 2, 2, 2, 2])
