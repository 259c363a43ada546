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
// One library is built per metric: ops/emit.py writes the metric's struct
// from its torch function into a header, which the build brings in with
// -include, and -DGRT_METRIC names the struct.  A library holds one kernel
// instance per value of the trace options that the step branches on at
// compile time (march.cuh's StepOptions: planar mode, the Euler integrator,
// affine reparameterisation: six instances), and its entry point picks the
// instance from its arguments.
//
// A baked build (GRT_BAKED_PARAMS defined as v0,v1,..., each value followed
// by a comma, in a header given with -include: nvcc splits a -D value at its
// commas) builds its metric inside the kernel from those compile-time values;
// the launch's metric argument is then not read, and grt_baked_params
// reports the values.
//
// Each library also holds the render-data kernel of its metric
// (`grt_render_data`, render_data.cuh): after the march, one thread per ray
// snaps the endpoint to the universe sphere, rotates a planar ray back,
// builds the two-pass frame basis at the endpoint and writes the texture
// coordinates, z_shift, side, status and angles that the shader reads.  It
// replaces no TPU kernel (the JAX package leaves render data to XLA's fused
// elementwise ops); it stands in for the ~2,600 eager torch ops a call that
// its plain twin (render/pipeline.py::compute_render_data_reference) takes.
// What bounds it: 68 bytes read a ray (84 with a planar ray's quaternion)
// and 28 written, against about 1,200 float operations a ray for each of the
// frame basis's one or two passes (20 metric inner products of 16 terms, all
// computed, as the eager sums compute their zero terms): at 3.35 TB/s and
// 67 TFLOP/s the two weigh about the same, a quarter of a millisecond for
// 8.3M rays.
//
// And it holds the observer tetrad at the camera's one point
// (`grt_observer_tetrad`, observer.cuh): one launch of one thread computes
// the metric there, the frame basis with all four legs, its inverse, the
// orientation of the three axes the chart made and the Lorentz boost, in
// place of the ~2,760 eager ops of its twin (camera.py::
// observer_tetrad_reference), each a launch a few floats wide.  What bounds
// it: the launch, and the latency of a chain of a few thousand dependent
// float operations in one thread; nothing here is worth a second thread.
//
// And it holds the launch state of every ray (`grt_launch_state`,
// launch_state.cuh): one thread per ray computes its pixel's direction, the
// velocity from the observer tetrad, in planar mode the rotation into the
// equator, the null fix, the launch acceleration, the step seed and
// ku_uobsu, and writes the (N, 4) / (N,) state that grt_raymarch reads, in
// place of the eager jvp over the whole batch of its twin (render/
// pipeline.py::rays_for_pixels_reference).  What bounds it: 68 bytes written
// a ray (84 with a planar ray's quaternion) against one metric evaluation
// and one acceleration a ray; the observer's g e0 at the camera, the same for
// every ray, is computed once a block.
//
// The kernels allocate nothing and do not synchronise; the wrapper
// (ops/raymarch.py) launches them on the current stream and checks each
// launch.
// The C entry points are plain C (loaded with ctypes, no PyTorch headers);
// metric parameters are kernel arguments.
#include <cuda_runtime.h>

#include "launch_state.cuh"
#include "march.cuh"
#include "observer.cuh"
#include "render_data.cuh"

#ifndef GRT_METRIC
#error "GRT_METRIC names the metric struct of an -include'd emitted header"
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

// The render data's inputs and outputs (render_data.cuh).  The (N, 4)
// state rows and the (N,) vectors are contiguous; the (4, N) polar
// position, polar velocity and inverse quaternions (null: not planar) are
// read through their strides (in floats), so that a chart's to_polar that
// returns a view of the state is read in place.
struct RenderArrays {
  const float4* pos;
  const float4* vel;
  const float* rdl;
  const int* status;
  const float* ku_uobsu;
  const float* polar;
  long long polar_s0, polar_s1;
  const float* polar_vel;
  long long polar_vel_s0, polar_vel_s1;
  const float* inv_quat;
  long long inv_quat_s0, inv_quat_s1;
  float2* tex;
  float* z_shift;
  int* side;
  int* terminated;
  float2* angles;
};

// One thread per ray, in index order: a ray's work does not depend on where
// it ended, so no tile map is needed.
template <class M>
__global__ void __launch_bounds__(GRT_THREADS)
    render_data_kernel(M m, grt::RenderConsts c, int n, RenderArrays r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
#ifdef GRT_BAKED_PARAMS
  constexpr float kBaked[] = {GRT_BAKED_PARAMS 0.0f};
  const M mk = M::from_params(kBaked);
#else
  const M& mk = m;
#endif
  grt::RayEnd e;
  const float4 p = r.pos[i], v = r.vel[i];
  e.pos[0] = p.x; e.pos[1] = p.y; e.pos[2] = p.z; e.pos[3] = p.w;
  e.vel[0] = v.x; e.vel[1] = v.y; e.vel[2] = v.z; e.vel[3] = v.w;
  e.rdl = r.rdl[i];
  e.status = r.status[i];
  e.ku_uobsu = r.ku_uobsu[i];
  for (int k = 0; k < 3; ++k) {
    e.polar[k] = r.polar[(k + 1) * r.polar_s0 + i * r.polar_s1];
    e.polar_vel[k] = r.polar_vel[(k + 1) * r.polar_vel_s0 + i * r.polar_vel_s1];
  }
  e.planar = r.inv_quat != nullptr;
  for (int k = 0; k < 4; ++k)
    e.inv_quat[k] =
        e.planar ? r.inv_quat[k * r.inv_quat_s0 + i * r.inv_quat_s1] : 0.0f;
  grt::RayRender o;
  grt::render_ray(mk, c, e, o);
  r.tex[i] = make_float2(o.tex[0], o.tex[1]);
  r.z_shift[i] = o.z_shift;
  r.side[i] = o.side;
  r.terminated[i] = o.terminated;
  r.angles[i] = make_float2(o.angles[0], o.angles[1]);
}

// The observer tetrad of one position, in one thread: reads x, gx, gy, gz
// (4,) and the frame 3-speed (null: 0), writes es (4, 4) row-major.
template <class M>
__global__ void observer_kernel(M m, const float* x, const float* gx,
                                const float* gy, const float* gz,
                                const float* speed, float* es) {
#ifdef GRT_BAKED_PARAMS
  constexpr float kBaked[] = {GRT_BAKED_PARAMS 0.0f};
  const M mk = M::from_params(kBaked);
#else
  const M& mk = m;
#endif
  const float rest[3] = {0.0f, 0.0f, 0.0f};
  float out[4][4];
  grt::observer_tetrad(mk, x, gx, gy, gz, speed != nullptr ? speed : rest,
                       out);
  for (int a = 0; a < 4; ++a)
    for (int mu = 0; mu < 4; ++mu) es[4 * a + mu] = out[a][mu];
}

// The launch state's inputs and outputs (launch_state.cuh).  Pixel rays
// read cx, cy (N,), the focal length (a 0-d tensor on the card) and the
// camera quaternion (4,); rays of a chart that is not the identity read
// their generic position and velocity (4, N) through their strides instead
// (gpos not null).  Every ray reads the camera's position x (4,) and tetrad
// es (4, 4) row-major.  The state is written as grt_raymarch reads it, and
// inv_quat (4, N) where not null (planar pixel rays).
struct LaunchArrays {
  const float* cx;
  const float* cy;
  const float* f_stop;
  const float* quat;
  const float* gpos;
  long long gpos_s0, gpos_s1;
  const float* gvel;
  long long gvel_s0, gvel_s1;
  const float* x;
  const float* es;
  float4* pos;
  float4* vel;
  float4* acc;
  float* next_ds;
  float* rdl;
  int* status;
  int* steps;
  float* ku_uobsu;
  float* inv_quat;
};

// One thread per ray, in index order.  The first thread of a block computes
// the observer's g e0 at the camera, which every ray of the block reads.
template <class M>
__global__ void __launch_bounds__(GRT_THREADS)
    launch_state_kernel(M m, grt::LaunchConsts c, int n, LaunchArrays r) {
#ifdef GRT_BAKED_PARAMS
  constexpr float kBaked[] = {GRT_BAKED_PARAMS 0.0f};
  const M mk = M::from_params(kBaked);
#else
  const M& mk = m;
#endif
  __shared__ float obs_low[4];
  if (threadIdx.x == 0) grt::observer_low(mk, r.x, r.es, obs_low);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  grt::Ray s;
  float ku;
  if (r.gpos != nullptr) {
    float pos[4], vel[4];
    for (int k = 0; k < 4; ++k) {
      pos[k] = r.gpos[k * r.gpos_s0 + i * r.gpos_s1];
      vel[k] = r.gvel[k * r.gvel_s0 + i * r.gvel_s1];
    }
    grt::launch_ray(mk, c, obs_low, pos, vel, s, ku);
  } else {
    float q[4], iq[4];
    for (int k = 0; k < 4; ++k) q[k] = r.quat[k];
    grt::launch_pixel(mk, c, obs_low, r.cx[i], r.cy[i], *r.f_stop, q, r.x,
                      r.es, s, ku, iq);
    if (r.inv_quat != nullptr)
      for (int k = 0; k < 4; ++k)
        r.inv_quat[static_cast<long long>(k) * n + i] = iq[k];
  }
  r.pos[i] = make_float4(s.pos[0], s.pos[1], s.pos[2], s.pos[3]);
  r.vel[i] = make_float4(s.vel[0], s.vel[1], s.vel[2], s.vel[3]);
  r.acc[i] = make_float4(s.acc[0], s.acc[1], s.acc[2], s.acc[3]);
  r.next_ds[i] = s.next_ds;
  r.rdl[i] = s.rdl;
  r.status[i] = s.status;
  r.steps[i] = s.steps;
  r.ku_uobsu[i] = ku;
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

// The render data of n ray endpoints (render_data.cuh): one launch on
// `stream`.  `mparams` as grt_raymarch's; `consts` the three floats of
// grt::RenderConsts (the squared universe and terminator radii, the far test
// radius) and `singular`, `traversable` its branches; `strides` the six
// strides of the (4, N) polar position, polar velocity and inverse
// quaternions (`inv_quat` null: not planar).  Writes tex (N, 2), z_shift
// (N,), side (N,) int, terminated (N,) int and angles (N, 2).  Returns the
// CUDA error of the launch (0 = launched).
extern "C" int grt_render_data(const float* mparams, const float* consts,
                               int singular, int traversable, int n,
                               const void* pos, const void* vel,
                               const void* rdl, const void* status,
                               const void* ku_uobsu, const void* polar,
                               const void* polar_vel, const void* inv_quat,
                               const long long* strides, void* tex,
                               void* z_shift, void* side, void* terminated,
                               void* angles, void* stream) {
  if (n <= 0) return 0;
  const RenderArrays r{static_cast<const float4*>(pos),
                       static_cast<const float4*>(vel),
                       static_cast<const float*>(rdl),
                       static_cast<const int*>(status),
                       static_cast<const float*>(ku_uobsu),
                       static_cast<const float*>(polar), strides[0],
                       strides[1], static_cast<const float*>(polar_vel),
                       strides[2], strides[3],
                       static_cast<const float*>(inv_quat), strides[4],
                       strides[5], static_cast<float2*>(tex),
                       static_cast<float*>(z_shift), static_cast<int*>(side),
                       static_cast<int*>(terminated),
                       static_cast<float2*>(angles)};
  const grt::RenderConsts c{consts[0], consts[1], consts[2], singular,
                            traversable};
  const Metric m = Metric::from_params(mparams);
  const int blocks = (n + GRT_THREADS - 1) / GRT_THREADS;
  render_data_kernel<Metric><<<blocks, GRT_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(m, c, n,
                                                                    r);
  return static_cast<int>(cudaGetLastError());
}

// The observer tetrad at the generic position `x` (4,), oriented by the
// generic axes gx, gy, gz (4,) and boosted to the frame 3-speed `speed` (3,;
// null: at rest): one launch of one thread on `stream`.  `mparams` as
// grt_raymarch's.  Writes es (4, 4), es[a][mu] = e_a^mu.  Returns the CUDA
// error of the launch (0 = launched).
extern "C" int grt_observer_tetrad(const float* mparams, const void* x,
                                   const void* gx, const void* gy,
                                   const void* gz, const void* speed,
                                   void* es, void* stream) {
  const Metric m = Metric::from_params(mparams);
  observer_kernel<Metric><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const float*>(x), static_cast<const float*>(gx),
      static_cast<const float*>(gy), static_cast<const float*>(gz),
      static_cast<const float*>(speed), static_cast<float*>(es));
  return static_cast<int>(cudaGetLastError());
}

// The launch state of n rays (launch_state.cuh): one launch on `stream`.
// `mparams` as grt_raymarch's; `consts` the four floats of
// grt::LaunchConsts (half width, half height, trace sign,
// max_acceleration_change) and `planar` its flag.  Pixel rays: cx, cy (N,),
// f_stop (1,), quat (4,), gpos null; otherwise gpos and gvel (4, N) with
// their four strides in `strides`.  x (4,) and es (4, 4) are the camera's
// position and tetrad.  Writes pos, vel, acc (N, 4), next_ds, rdl (N,),
// status, steps (N,) int, ku_uobsu (N,) and, not null, inv_quat (4, N).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int grt_launch_state(const float* mparams, const float* consts,
                                int planar, int n, const void* cx,
                                const void* cy, const void* f_stop,
                                const void* quat, const void* gpos,
                                const void* gvel, const long long* strides,
                                const void* x, const void* es, void* pos,
                                void* vel, void* acc, void* next_ds,
                                void* rdl, void* status, void* steps,
                                void* ku_uobsu, void* inv_quat,
                                void* stream) {
  if (n <= 0) return 0;
  const LaunchArrays r{static_cast<const float*>(cx),
                       static_cast<const float*>(cy),
                       static_cast<const float*>(f_stop),
                       static_cast<const float*>(quat),
                       static_cast<const float*>(gpos), strides[0],
                       strides[1], static_cast<const float*>(gvel),
                       strides[2], strides[3], static_cast<const float*>(x),
                       static_cast<const float*>(es),
                       static_cast<float4*>(pos), static_cast<float4*>(vel),
                       static_cast<float4*>(acc),
                       static_cast<float*>(next_ds), static_cast<float*>(rdl),
                       static_cast<int*>(status), static_cast<int*>(steps),
                       static_cast<float*>(ku_uobsu),
                       static_cast<float*>(inv_quat)};
  const grt::LaunchConsts c{consts[0], consts[1], consts[2], consts[3],
                            planar};
  const Metric m = Metric::from_params(mparams);
  const int blocks = (n + GRT_THREADS - 1) / GRT_THREADS;
  launch_state_kernel<Metric><<<blocks, GRT_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(m, c, n,
                                                                     r);
  return static_cast<int>(cudaGetLastError());
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
