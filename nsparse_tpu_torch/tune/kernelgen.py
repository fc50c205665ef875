"""Window-arena geometry read by the port's planner.

The JAX package derives these per chip (``nsparse_tpu/tune/kernelgen.py``)
and, off the TPU, uses its CPU config (``tune/_generated_cpu.py``).  The
port takes those CPU values so that its plans equal the JAX package's
index-form plans array for array; a geometry derived from the H100's
shared memory and SM count is later work (ROADMAP).
"""

WIN_MIN = 1024        # smallest window width (slots)
N_WIN_CLASSES = 6     # window widths WIN_MIN << j, j < N_WIN_CLASSES
