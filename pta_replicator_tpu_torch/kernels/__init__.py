"""Hand-written CUDA kernels: their build and their launch counts.

``launches`` maps a kernel wrapper's name to the number of times it has
launched its kernel in this process; each wrapper adds one per launch and
nowhere else, so a run can show that a path went through its kernels.
Clear it before the run to be read.
"""
from collections import Counter

launches: Counter = Counter()
