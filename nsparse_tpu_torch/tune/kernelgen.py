"""Kernel geometry read by the port's planners.

The JAX package derives these per chip (``nsparse_tpu/tune/kernelgen.py``)
and, off the TPU, uses its CPU config (``tune/_generated_cpu.py``) and
the window supertile of ``ops/kernels/gather_pallas.py``.  The port takes
those CPU values so that its plans equal the JAX package's array for
array; a geometry derived from the H100's shared memory and SM count is
later work (ROADMAP).
"""

# SpGEMM window arena
WIN_MIN = 1024        # smallest window width (slots)
N_WIN_CLASSES = 6     # window widths WIN_MIN << j, j < N_WIN_CLASSES

# flat-gather class ladder, cheapest first: ("band", D) routes
# (BAND_TILE_ROWS, 128) supertiles whose idx - position spans < D;
# ("win", W) routes supertiles of WIN_SUB (WIN_TILE_ROWS, 128) subtiles
# whose indices span < W
GATHER_CLASSES = (("band", 1), ("band", 16), ("band", 128), ("win", 128),
                  ("win", 1024))
BAND_TILE_ROWS = 128
WIN_TILE_ROWS = 8
WIN_SUB = 8
