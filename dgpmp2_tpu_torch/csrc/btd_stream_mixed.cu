// K-STREAM, the df32 engine's mixed instance.  The kernels are in
// btd_stream.cuh; each instance has its own source, so that nvcc builds
// the three in parallel.
#include "btd_stream.cuh"

// The df32 engine's instance: float32 residuals and x, float64 blocks,
// assembly, pivots, gain and z.
extern "C" int dgpmp2_btd_stream_mixed(const StreamArgs* a, void* stream) {
  return launch<double, float>(a, stream);
}

// The lane-group launch plan at D <= 16 (narrow_geometry).
extern "C" int dgpmp2_btd_stream_mixed_geometry(int d, int batch, int* out) {
  return narrow_geometry<double, float>(d, batch, out);
}

// The wide and block kernels' attributes and occupancy (rows_attrs,
// rows_occupancy), for ops/cuda/btd_stream.py's launch plan.
extern "C" int dgpmp2_btd_stream_mixed_rows_attrs(int block, int* out) {
  return rows_attrs<double, float>(block, out);
}

extern "C" int dgpmp2_btd_stream_mixed_rows_occupancy(int block, int threads,
                                                    int smem, int* out) {
  return rows_occupancy<double, float>(block, threads, smem, out);
}
