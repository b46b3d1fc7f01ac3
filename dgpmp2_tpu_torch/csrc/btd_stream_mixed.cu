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
