// K-STREAM, the float64 instance.  The kernels are in
// btd_stream.cuh; each instance has its own source, so that nvcc builds
// the three in parallel.
#include "btd_stream.cuh"

extern "C" int dgpmp2_btd_stream_f64(const StreamArgs* a, void* stream) {
  return launch<double, double>(a, stream);
}

// The lane-group launch plan at D <= 16 (narrow_geometry).
extern "C" int dgpmp2_btd_stream_f64_geometry(int d, int batch, int* out) {
  return narrow_geometry<double, double>(d, batch, out);
}

// The wide and block kernels' attributes and occupancy (rows_attrs,
// rows_occupancy), for ops/cuda/btd_stream.py's launch plan.
extern "C" int dgpmp2_btd_stream_f64_rows_attrs(int block, int* out) {
  return rows_attrs<double, double>(block, out);
}

extern "C" int dgpmp2_btd_stream_f64_rows_occupancy(int block, int threads,
                                                    int smem, int* out) {
  return rows_occupancy<double, double>(block, threads, smem, out);
}
