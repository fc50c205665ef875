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

# piece expansion from the pre-rolled B bank (ops/kernels/piecewise.py).
# Parity values: the JAX CPU config's, so the port's piece tables and its
# choice of the v2 numeric form equal the JAX package's.  BANK_K copies of
# the 8-aligned B table, each rolled 8 slots further; a bank of more than
# BANK_ROWS_MAX rows takes the unaligned piece mode (K2's flat mode, on a
# one-copy K11 table); each live 1024-slot subtile of the piecewise arena
# joins the first class whose piece budget covers its piece count.
BANK_K = 16
BANK_ROWS_MAX = 1600
PW_J_CLASSES = (2, 4, 8, 16, 32, 64, 128)

# flat-gather class ladder, cheapest first: ("band", D) routes
# (BAND_TILE_ROWS, 128) supertiles whose idx - position spans < D;
# ("win", W) routes supertiles of WIN_SUB (WIN_TILE_ROWS, 128) subtiles
# whose indices span < W
GATHER_CLASSES = (("band", 1), ("band", 16), ("band", 128), ("win", 128),
                  ("win", 1024))
BAND_TILE_ROWS = 128
WIN_TILE_ROWS = 8
WIN_SUB = 8

# block-sparse SpGEMM: tile edge and the cost model of choose_spgemm_path
# (ns per ESC intermediate product, us per tile pair).  These are the JAX
# CPU config's values, so the port's block plans and path choices equal the
# JAX package's; costs measured on the H100 are later work (ROADMAP, queue
# A: the kernelgen geometry of the bench stages).  BSR_PAIRS_PER_STEP is
# the JAX value at which its plans pad no pair run; it is a parity value
# only: K9 walks each C tile's run whole, so the port never pads.
BSR_BS = 256
BSR_PAIRS_PER_STEP = 1
ESC_NS_PER_PRODUCT = 122.85
BSR_US_PER_PAIR = 20.97
