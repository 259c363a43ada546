// Ray-march kernel for Hopper (sm_90a): one thread per ray, a warp per 8x4
// pixel tile.
//
// Replaces the TPU kernel `geodesic_raytracing_tpu/ops/pallas/raymarch.py::
// launch` (the pallas_call that marches (8, tile/8) lane tiles of rays in
// VMEM).  Each thread loads its ray's state (float4 rows of the (N, 4)
// RayState tensors), keeps it in registers and runs `march_ray` (march.cuh)
// until the ray leaves ACTIVE or reaches the step budget, then stores it
// back in place.
//
// What bounds it: FP32 instruction rate (one pruned dual metric evaluation
// with its sincos and reciprocals, the pruned contraction and inverse, the
// step controller: a few hundred instructions per trial iteration), not
// memory: 68 bytes per ray are read and 64 written, once.  The SM's
// schedulers start an instruction nearly every cycle, so the time follows
// the instructions per iteration times the iterations of each warp's slowest
// ray.  The design therefore prunes the duals' structural zeros, shares one
// range reduction between sin and cos, and, when the rays are the pixels of
// a row-major image (`width` > 0), gives each warp an 8x4 pixel tile instead
// of 32 pixels of a row: neighbours in both directions end after more
// similar iteration counts, so fewer lanes idle while the slowest ray of
// their warp runs on.  A ray's arithmetic does not depend on its thread, so
// the map changes no result.
//
// Build switches (-D): GRT_THREADS and GRT_MIN_BLOCKS are the launch bounds
// (256 threads and 4 blocks an SM: at most 64 registers a thread).  For
// measurement, GRT_ROW_WARPS keeps 32 rays in index order per warp whatever
// the width, and GRT_FULL_TANGENTS (march.cuh) and GRT_SEPARATE_TRIG
// (dual.cuh) restore the unpruned duals and the separate sinf and cosf calls.
//
// One library is built per metric: -DGRT_METRIC names the metric struct of
// metrics.cuh (default KerrBoyer).  A library holds one kernel instance per
// value of the trace options that the step branches on at compile time
// (march.cuh's StepOptions: planar mode, the Euler integrator, affine
// reparameterisation: six instances), and its entry point picks the instance
// from its arguments.
//
// A baked build (GRT_BAKED_PARAMS defined as v0,v1,..., each value followed
// by a comma, in a header given with -include: nvcc splits a -D value at its
// commas) builds its metric inside the kernel from those compile-time values,
// so that nvcc folds the parameters through the step; the launch's metric
// argument is then not read, and grt_baked_params reports the values.  The
// metric struct may also come from a header that ops/emit.py wrote
// (-include <header> -DGRT_METRIC=<struct>).
//
// The kernel allocates nothing and does not synchronise; the wrapper
// (ops/raymarch.py) launches it on the current stream and checks the launch.
// The C entry points are plain C (loaded with ctypes, no PyTorch headers);
// metric parameters are kernel arguments.
#include <cuda_runtime.h>

#include "march.cuh"

#ifndef GRT_METRIC
#define GRT_METRIC KerrBoyer
#endif

#ifndef GRT_THREADS
#define GRT_THREADS 256
#endif
#ifndef GRT_MIN_BLOCKS
#define GRT_MIN_BLOCKS 4
#endif

namespace {

static_assert(GRT_THREADS % 32 == 0, "whole warps");

// The (N,)-ray state in place, the launch |v^t| of each ray, and, where not
// null, an output for measurement: each marched ray's trial iterations.
struct RayArrays {
  float4* pos;
  float4* vel;
  float4* acc;
  float* next_ds;
  float* rdl;
  int* status;
  int* steps;
  const float* f_in_x;
  int* trials;
};

// Loads ray i; false (and nothing to store later) unless it is ACTIVE.
__device__ __forceinline__ bool load_ray(const RayArrays& r, int i,
                                         grt::Ray& s, float& f_in_x) {
  if (r.status[i] != grt::ACTIVE) return false;
  const float4 p = r.pos[i], v = r.vel[i], a = r.acc[i];
  s.pos[0] = p.x; s.pos[1] = p.y; s.pos[2] = p.z; s.pos[3] = p.w;
  s.vel[0] = v.x; s.vel[1] = v.y; s.vel[2] = v.z; s.vel[3] = v.w;
  s.acc[0] = a.x; s.acc[1] = a.y; s.acc[2] = a.z; s.acc[3] = a.w;
  s.next_ds = r.next_ds[i];
  s.rdl = r.rdl[i];
  s.status = grt::ACTIVE;
  s.steps = r.steps[i];
  f_in_x = r.f_in_x[i];
  return true;
}

__device__ __forceinline__ void store_ray(const RayArrays& r, int i,
                                          const grt::Ray& s, int trials) {
  r.pos[i] = make_float4(s.pos[0], s.pos[1], s.pos[2], s.pos[3]);
  r.vel[i] = make_float4(s.vel[0], s.vel[1], s.vel[2], s.vel[3]);
  r.acc[i] = make_float4(s.acc[0], s.acc[1], s.acc[2], s.acc[3]);
  r.next_ds[i] = s.next_ds;
  r.rdl[i] = s.rdl;
  r.status[i] = s.status;
  r.steps[i] = s.steps;
  if (r.trials != nullptr) r.trials[i] = trials;
}

// Warp tiles of a row-major image: 8 pixels wide, 4 high.
constexpr int kTileW = 8, kTileH = 4;
static_assert(kTileW * kTileH == 32, "one tile per warp");

// The ray of thread t, or -1 for none.  width == 0: ray t.  Otherwise the
// rays are the pixels of a row-major image of that width and n / width
// rows; warp t / 32 takes tile t / 32 (tiles in row-major order, ragged at
// the right and bottom edges) and lane t % 32 the pixel (lane % 8, lane / 8)
// of it.  ops/raymarch.py::tile_ray_index is the same map in numpy.
__device__ __forceinline__ int ray_of_thread(int t, int n, int width) {
#ifdef GRT_ROW_WARPS
  width = 0;
#endif
  if (width == 0) return t < n ? t : -1;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tile = t / 32, lane = t % 32;
  const int x = (tile % tiles_x) * kTileW + lane % kTileW;
  const int y = (tile / tiles_x) * kTileH + lane / kTileW;
  return (x < width && y < n / width) ? y * width + x : -1;
}

template <class M, class Opt>
__global__ void __launch_bounds__(GRT_THREADS, GRT_MIN_BLOCKS)
    raymarch_kernel(M m, grt::Features f, int n, int width, int max_steps,
                    RayArrays r) {
  const int i = ray_of_thread(blockIdx.x * blockDim.x + threadIdx.x, n, width);
  grt::Ray s;
  float f_in_x;
  if (i < 0 || !load_ray(r, i, s, f_in_x)) return;
#ifdef GRT_BAKED_PARAMS
  constexpr float kBaked[] = {GRT_BAKED_PARAMS 0.0f};
  const M mk = M::from_params(kBaked);
#else
  const M& mk = m;
#endif
  const int trials = grt::march_ray<Opt>(mk, f, f_in_x, max_steps, s);
  store_ray(r, i, s, trials);
}

template <class M, class Opt>
int launch(const M& m, const grt::Features& f, int n, int width,
           int max_steps, const RayArrays& r, void* stream) {
  long long threads = n;
  if (width > 0) {
    const long long tiles_x = (width + kTileW - 1) / kTileW;
    const long long tiles_y = (n / width + kTileH - 1) / kTileH;
    threads = tiles_x * tiles_y * 32;
  }
  const int blocks = static_cast<int>((threads + GRT_THREADS - 1) / GRT_THREADS);
  raymarch_kernel<M, Opt><<<blocks, GRT_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      m, f, n, width, max_steps, r);
  return static_cast<int>(cudaGetLastError());
}

using Metric = grt::GRT_METRIC;

}  // namespace

// Marches every ACTIVE ray of an (N,)-ray state in place.  `mparams` is a
// host array of the metric's parameters in the order of its struct, `feats`
// one of the 8 floats of grt::Features; `planar`, `euler` and
// `reparameterisation` are the trace options (0 or 1); `width` is the width
// of the row-major image whose pixels the rays are (a divisor of n), or 0;
// `trials` (N,) ints or null (see RayArrays).  Returns the CUDA error of the
// launch (0 = launched).
extern "C" int grt_raymarch(const float* mparams, const float* feats,
                            int planar, int euler, int reparameterisation,
                            int n, int width, int max_steps, void* pos,
                            void* vel, void* acc, void* next_ds, void* rdl,
                            void* status, void* steps, const void* f_in_x,
                            void* trials, void* stream) {
  if (n <= 0 || max_steps <= 0) return 0;
  if (width < 0 || (width > 0 && n % width != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const RayArrays r{static_cast<float4*>(pos),    static_cast<float4*>(vel),
                    static_cast<float4*>(acc),    static_cast<float*>(next_ds),
                    static_cast<float*>(rdl),     static_cast<int*>(status),
                    static_cast<int*>(steps),
                    static_cast<const float*>(f_in_x),
                    static_cast<int*>(trials)};
  const Metric m = Metric::from_params(mparams);
  const grt::Features f = grt::features_from(feats);
#define GRT_LAUNCH(P, E, R) \
  launch<Metric, grt::StepOptions<P, E, R>>(m, f, n, width, max_steps, r, stream)
  // The Euler step ignores reparameterisation (its K is 1).
  if (euler) return planar ? GRT_LAUNCH(true, true, false)
                           : GRT_LAUNCH(false, true, false);
  if (reparameterisation)
    return planar ? GRT_LAUNCH(true, false, true)
                  : GRT_LAUNCH(false, false, true);
  return planar ? GRT_LAUNCH(true, false, false)
                : GRT_LAUNCH(false, false, false);
#undef GRT_LAUNCH
}

// The metric this library was built for and the number of its parameters.
extern "C" const char* grt_metric_name(int* n_params) {
  *n_params = Metric::n_params;
  return Metric::name;
}

// Threads per block and the resident blocks per SM that the occupancy
// calculator gives the kernel (the instance of the default options).
extern "C" int grt_raymarch_config(int* threads, int* blocks_per_sm) {
  *threads = GRT_THREADS;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, raymarch_kernel<Metric, grt::DefaultOptions>,
      GRT_THREADS, 0));
}

// The parameter values a baked build has compiled in (n = their number),
// or null with n = -1 for a build that takes them at launch.
extern "C" const float* grt_baked_params(int* n) {
#ifdef GRT_BAKED_PARAMS
  static const float baked[] = {GRT_BAKED_PARAMS 0.0f};
  *n = static_cast<int>(sizeof(baked) / sizeof(float)) - 1;
  return baked;
#else
  *n = -1;
  return nullptr;
#endif
}

extern "C" const char* grt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
