// Unrolling of the kernels' per-feature and per-output loops (the fused_*
// sources). The narrow width buckets unroll them fully, so a thread's
// node rows stay in registers. The wide buckets (-DMPNN_FP=32,
// kernels/build.py::WIDE) unroll them by 8: fully unrolled at f 32 and od
// 64-128, nvcc took 4-13 minutes per source on the H100 build machine,
// more than a chip_smoke.py run can spend, and those rows spill to local
// memory either way. Unrolled by 1, 4 and 8 the whole build took 85, 67
// and 93 s, and the wide kernels ran fastest unrolled by 8 (PERF.md).

#pragma once

#ifndef MPNN_FP
#define MPNN_FP 16
#endif

#if MPNN_FP > 16
#define MPNN_UNROLL _Pragma("unroll 8")
#else
#define MPNN_UNROLL _Pragma("unroll")
#endif
