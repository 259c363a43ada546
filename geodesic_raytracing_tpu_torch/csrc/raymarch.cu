// Ray-march kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernel `geodesic_raytracing_tpu/ops/pallas/raymarch.py::
// launch` (the pallas_call that marches (8, tile/8) lane tiles of rays in
// VMEM).  Each thread loads its ray's state (float4 rows of the (N, 4)
// RayState tensors: neighbouring threads read neighbouring 16-byte rows),
// keeps it in registers and runs `march_ray` (march.cuh) until the ray
// leaves ACTIVE or reaches the step budget, then stores it back in place.
//
// What bounds it: FP32 ALU work per step (one Dual<2> metric evaluation with
// its sin/cos/reciprocals, the pruned contraction and inverse, the step
// controller) and divergence within a warp, not memory: about 17 floats per
// ray are read once and written once.  The design answers divergence by
// making it per warp (32 rays) instead of per 2048-ray tile: each thread
// exits as soon as its own ray finishes.  The kernel allocates nothing and
// does not synchronise; the wrapper (ops/raymarch.py) launches it on the
// current stream and checks the launch.
//
// The C entry points are plain C (loaded with ctypes, no PyTorch headers),
// one per metric instance; metric parameters are kernel arguments.
#include <cuda_runtime.h>

#include "march.cuh"

namespace {

constexpr int kThreads = 256;

template <class M>
__global__ void __launch_bounds__(kThreads)
    raymarch_kernel(M m, grt::Features f, int n, int max_steps, float4* pos,
                    float4* vel, float4* acc, float* next_ds, float* rdl,
                    int* status, int* steps, const float* f_in_x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || status[i] != grt::ACTIVE) return;

  grt::Ray s;
  const float4 p = pos[i], v = vel[i], a = acc[i];
  s.pos[0] = p.x; s.pos[1] = p.y; s.pos[2] = p.z; s.pos[3] = p.w;
  s.vel[0] = v.x; s.vel[1] = v.y; s.vel[2] = v.z; s.vel[3] = v.w;
  s.acc[0] = a.x; s.acc[1] = a.y; s.acc[2] = a.z; s.acc[3] = a.w;
  s.next_ds = next_ds[i];
  s.rdl = rdl[i];
  s.status = grt::ACTIVE;
  s.steps = steps[i];

  grt::march_ray(m, f, f_in_x[i], max_steps, s);

  pos[i] = make_float4(s.pos[0], s.pos[1], s.pos[2], s.pos[3]);
  vel[i] = make_float4(s.vel[0], s.vel[1], s.vel[2], s.vel[3]);
  acc[i] = make_float4(s.acc[0], s.acc[1], s.acc[2], s.acc[3]);
  next_ds[i] = s.next_ds;
  rdl[i] = s.rdl;
  status[i] = s.status;
  steps[i] = s.steps;
}

template <class M>
int launch(const M& m, const float* feats, int n, int max_steps, void* pos,
           void* vel, void* acc, void* next_ds, void* rdl, void* status,
           void* steps, const void* f_in_x, void* stream) {
  if (n <= 0) return 0;
  const grt::Features f{feats[0], feats[1], feats[2],
                        feats[3], feats[4], feats[5]};
  const int blocks = (n + kThreads - 1) / kThreads;
  raymarch_kernel<M><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      m, f, n, max_steps, static_cast<float4*>(pos),
      static_cast<float4*>(vel), static_cast<float4*>(acc),
      static_cast<float*>(next_ds), static_cast<float*>(rdl),
      static_cast<int*>(status), static_cast<int*>(steps),
      static_cast<const float*>(f_in_x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Marches every ACTIVE ray of an (N,)-ray state in place.  `feats` is a
// host array of the 6 Features fields.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int grt_raymarch_kerr_boyer(float rs, float a, const float* feats,
                                       int n, int max_steps, void* pos,
                                       void* vel, void* acc, void* next_ds,
                                       void* rdl, void* status, void* steps,
                                       const void* f_in_x, void* stream) {
  return launch(grt::KerrBoyer{rs, a}, feats, n, max_steps, pos, vel, acc,
                next_ds, rdl, status, steps, f_in_x, stream);
}

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
