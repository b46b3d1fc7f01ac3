// K-STREAM, the producer cap and the float32 instance.  The kernels are in
// btd_stream.cuh; each instance has its own source, so that nvcc builds
// the three in parallel.
#include "btd_stream.cuh"

int dgpmp2_stream::producer_cap = 0;

// The most producer warps a lane-group block of any instance takes from the
// next launch on (0: the kernel's most), for measuring the choice;
// returns the previous cap.
extern "C" int dgpmp2_btd_stream_set_producers(int n) {
  const int prev = dgpmp2_stream::producer_cap;
  dgpmp2_stream::producer_cap = n < 0 ? 0 : n;
  return prev;
}

extern "C" int dgpmp2_btd_stream_f32(const StreamArgs* a, void* stream) {
  return launch<float, float>(a, stream);
}

// The lane-group launch plan at D <= 16 (narrow_geometry).
extern "C" int dgpmp2_btd_stream_f32_geometry(int d, int batch, int* out) {
  return narrow_geometry<float, float>(d, batch, out);
}


// The wide and block kernels' attributes and occupancy (rows_attrs,
// rows_occupancy), for ops/cuda/btd_stream.py's launch plan.
extern "C" int dgpmp2_btd_stream_f32_rows_attrs(int block, int* out) {
  return rows_attrs<float, float>(block, out);
}

extern "C" int dgpmp2_btd_stream_f32_rows_occupancy(int block, int threads,
                                                    int smem, int* out) {
  return rows_occupancy<float, float>(block, threads, smem, out);
}
