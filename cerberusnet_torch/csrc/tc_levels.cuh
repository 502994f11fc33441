// The tensor-core instantiations of the fused encoder level, one row per
// level: (C, F, forward tile rows, columns, reverse-sweep tile rows,
// columns, reverse-sweep blocks per SM, threads, and whether its weight
// gradients stay in registers (KEEP)). encoder_level.cu builds its kernels
// from these rows; the Python wrapper (ops/cuda/encoder_level.py, _tc_rows)
// and the C++ operators (cerberus_ops.cc) read their tiles from them, so
// keep one X(...) per line. Where one reverse-sweep block fills an SM it
// runs 16 warps, to hide the latency of its loads. KEEP holds a block's dk
// (20 KB at level 1, 92 KB at level 2) in its registers; level 3's (369 KB)
// does not fit, so its slot is updated in device memory.
#pragma once

#define TC_LEVELS(X)                    \
  X(3, 16, 16, 32, 16, 16, 2, 256, 1)   \
  X(16, 32, 16, 16, 16, 16, 1, 512, 1)  \
  X(32, 64, 8, 8, 8, 16, 1, 512, 0)
